"""The port's optimizer and gradient compression (`optim/`) against the
JAX package's on the CPU, and its quickselect cost helpers:

  * `adamw_update` over 3 steps on a carried tree (float32 leaves and a
    bf16 one, gradients from numpy, one large enough to clip): params,
    m and v within 1e-6 of max |JAX| each step, the step counter, the
    grad norm and lr;
  * `cosine_schedule` over warm-up, decay and past the end, and
    `global_norm`, within 1e-6 relative;
  * `topk_compress_update` bitwise (ties included: equal |g| keep the
    lower flat index first, as `jax.lax.top_k`), `init_error_state`,
    `int8_allreduce_sim` bitwise for the same key, `wire_bytes`;
  * `quickselect.expected_comparisons` and `quickselect_cost` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mpc import quickselect as j_qs
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch.core import tree
from repro_torch.mpc import prng, quickselect as qs
from repro_torch.optim import adamw, compress

TOL = 1e-6


def np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "layers": {"a": (rng.standard_normal((3, 4, 2)) * scale)
                       .astype(np.float32),
                       "b": (rng.standard_normal(7) * scale)
                       .astype(np.float32)}}


def close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-30)


def test_adamw_three_steps_match_jax():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    j_cfg = j_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    p0 = np_tree(0)
    params = tree.to_device(p0, "cpu")
    params["h"] = torch.tensor([1.5, -2.25, 0.125], dtype=torch.bfloat16)
    jp = jax.tree.map(jnp.asarray, p0)
    jp["h"] = jnp.asarray([1.5, -2.25, 0.125], jnp.bfloat16)
    state, j_state = adamw.init_opt_state(params), j_adamw.init_opt_state(jp)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert all(x.dtype == torch.float32 for x in tree.tree_leaves(state["m"]))
    for i in range(3):
        # the second step's gradients are large enough to be clipped
        g = np_tree(10 + i, scale=5.0 if i == 1 else 0.1)
        g["h"] = np.array([0.3, -0.1, 2.0], np.float32) * (i + 1)
        jp, j_state, j_stats = j_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), j_state, j_cfg)
        params, state, stats = adamw.adamw_update(
            params, tree.to_device(g, "cpu"), state, cfg)
        assert int(state["step"]) == int(j_state["step"]) == i + 1
        close(stats["grad_norm"], j_stats["grad_norm"])
        close(stats["lr"], j_stats["lr"])
        for name, ours, theirs in (("p", params, jp), ("m", state["m"],
                                                      j_state["m"]),
                                   ("v", state["v"], j_state["v"])):
            for x, y in zip(tree.tree_leaves(ours), jax.tree.leaves(theirs)):
                assert str(x.dtype).split(".")[-1] == str(y.dtype), name
                close(x, np.asarray(y, np.float32), TOL if x.dtype !=
                      torch.bfloat16 else 2 ** -8)
    assert float(stats["grad_norm"]) > 0


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 101, 5000, 9999,
                                  10_000, 20_000])
def test_cosine_schedule_matches_jax(step):
    cfg, j_cfg = adamw.AdamWConfig(), j_adamw.AdamWConfig()
    close(adamw.cosine_schedule(cfg, step),
          j_adamw.cosine_schedule(j_cfg, step))


def test_global_norm_and_clipping_scale():
    g = np_tree(4, scale=3.0)
    close(adamw.global_norm(tree.to_device(g, "cpu")),
          j_adamw.global_norm(jax.tree.map(jnp.asarray, g)))


def test_topk_compress_update_is_bitwise_jax_with_ties():
    g = np_tree(7, scale=0.1)
    e = np_tree(8, scale=0.01)
    # ties across the cut: 10 entries of |g + e| = 2 for k = 6 kept
    g["w"][0, :] = 2.0
    g["w"][1, :] = -2.0
    e["w"][:2] = 0.0
    sparse, errs = compress.topk_compress_update(
        tree.to_device(g, "cpu"), tree.to_device(e, "cpu"), ratio=0.2)
    j_sparse, j_errs = j_compress.topk_compress_update(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e),
        ratio=0.2)
    for x, y in zip(tree.tree_leaves(sparse) + tree.tree_leaves(errs),
                    jax.tree.leaves(j_sparse) + jax.tree.leaves(j_errs)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    kept = sparse["w"].reshape(-1) != 0
    assert kept[:6].all() and not kept[6:].any()
    zero = compress.init_error_state(tree.to_device(g, "cpu"))
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree.tree_leaves(zero))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_int8_allreduce_sim_is_bitwise_jax(seed):
    g = np_tree(seed % 1000, scale=4.0)
    got = compress.int8_allreduce_sim(tree.to_device(g, "cpu"),
                                      prng.key(seed))
    want = j_compress.int8_allreduce_sim(jax.tree.map(jnp.asarray, g),
                                         jax.random.PRNGKey(seed))
    for x, y in zip(tree.tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("scheme", ["topk", "int8", "none"])
def test_wire_bytes_matches_jax(scheme):
    g = np_tree(1)
    assert compress.wire_bytes(tree.to_device(g, "cpu"), scheme, 0.05) == \
        j_compress.wire_bytes(jax.tree.map(jnp.asarray, g), scheme, 0.05)


@pytest.mark.parametrize("n,wave,coalesce", [
    (1, 1, True), (2, 1, True), (1000, 1, True), (1000, 8, True),
    (1000, 8, False), (42000, 16, False)])
def test_quickselect_cost_helpers_match_jax(n, wave, coalesce):
    assert qs.expected_comparisons(n, 3) == j_qs.expected_comparisons(n, 3)
    assert qs.quickselect_cost(n, wave, coalesce) == \
        j_qs.quickselect_cost(n, wave, coalesce)
