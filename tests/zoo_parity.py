"""Parity checks of the model zoo's smoke configs, the port against the
JAX package on the CPU, shared by the test_torch_zoo_*.py files: each
imports the checks below and names its architectures in an `arch`
fixture, so that the suite's workers (`--dist loadfile`) split the JAX
side's compiles between files.

Each architecture's weights are built by the JAX package from key 0,
once a module, and carried across with `core.tree.to_device`; tokens,
patches and frames come from numpy. Tolerances: the largest error within
1e-4 of max |JAX| at `dtype="float32"`; at the configs' bfloat16
activations within 2e-2 of max(1, max |JAX|). tests/test_models.py's
2e-2, absolute, was set at tied-embedding configs whose logits stay
below 1; the untied smoke configs' logits reach 3-4, where one bfloat16
rounding is 0.016-0.031 (the port against the JAX package measured
0.023-0.040 there). The moe family's bfloat16 logits are held by
correlation: a token whose top-k experts sit within a rounding of a tie
routes differently under another order of bfloat16 sums (the JAX
package's own compiled forward and its op-by-op one, `jax.disable_jit`,
differ by up to 0.98 on such a token); its MoE layer is held at the
bfloat16 tolerance on equal inputs (test_torch_zoo.py), and its float32
forward and serving at 1e-4.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import transformer as j_T
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.models import transformer as T

F32_TOL, BF16_TOL = 1e-4, 2e-2
S, STEPS = 12, 2                 # prompt tokens, decode steps of serving
# the JAX entry points compiled once per config (eager, each op and each
# layer scan compiles on its own, which takes seconds a call)
j_prefill = jax.jit(j_T.prefill, static_argnums=(1, 3))
j_decode = jax.jit(j_T.decode_step, static_argnums=(1,))


def cfgs(arch, dtype, **kw):
    j_cfg = dataclasses.replace(j_base.load_arch(arch, smoke=True),
                                dtype=dtype, **kw)
    cfg = dataclasses.replace(base.load_arch(arch, smoke=True), dtype=dtype,
                              **kw)
    return j_cfg, cfg


def prefix_of(cfg):
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def batch_for(cfg, seed, b=2, s=16):
    """Tokens, and the vlm patches / encdec frames (16 of them), from
    numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.cache
def jax_weights(arch):
    """The JAX package's smoke weights from key 0, and the port's copy:
    built once per module."""
    jp = j_T.init_params(jax.random.key(0), j_base.load_arch(arch, smoke=True))
    return jp, tree.to_device(jax.tree.map(np.asarray, jp), "cpu")


def assert_close(got, want, dtype, moe=False):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        assert err <= F32_TOL * float(np.abs(want).max()), err
    elif moe:
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    else:
        assert err <= BF16_TOL * max(1.0, float(np.abs(want).max())), err


def leaves(tr, path=()):
    """{key path: tensor} of a parameter tree."""
    if isinstance(tr, dict):
        return {k: v for key, sub in tr.items()
                for k, v in leaves(sub, path + (key,)).items()}
    return {path: tr}


def run_both(arch, dtype, seed=2, op_by_op=False, **kw):
    """prefill on S tokens (max_len prefix + S + 4) then STEPS decode
    steps in both packages: cfg, ([logits], cache) of the port's, and of
    JAX's. With `op_by_op` JAX's decode steps run under
    jax.disable_jit(), each op as its code writes it
    (test_torch_zoo_int8.py says why)."""
    j_cfg, cfg = cfgs(arch, dtype, **kw)
    jp, p = jax_weights(arch)
    batch = batch_for(cfg, seed, s=S + STEPS)
    tok = batch["tokens"]
    max_len = prefix_of(cfg) + S + 4
    first = {**batch, "tokens": tok[:, :S]}
    lg, cache = T.prefill(p, cfg, first, max_len=max_len)
    j_lg, j_cache = j_prefill(jp, j_cfg, jax_batch(first), max_len)
    out, j_out = [lg], [j_lg]
    for j in range(STEPS):
        pos = prefix_of(cfg) + S + j
        step = {"tokens": tok[:, S + j:S + j + 1]}
        lg, cache = T.decode_step(p, cfg, cache, step, pos)
        with jax.disable_jit() if op_by_op else contextlib.nullcontext():
            j_lg, j_cache = (j_T.decode_step if op_by_op else j_decode)(
                jp, j_cfg, j_cache, jax_batch(step),
                pos if op_by_op else jnp.int32(pos))
        out.append(lg)
        j_out.append(j_lg)
    return cfg, (out, cache), (j_out, j_cache)


# ---------------------------------------------------------------------------
# the checks each test_torch_zoo_<group>.py imports (its `arch` fixture
# names the architectures)
# ---------------------------------------------------------------------------

def test_init_params_keys_shapes_and_scales_match_jax(arch):
    """The port's own init_params gives the JAX tree's keys and shapes,
    float32 leaves, the same constant leaves (norm scales and biases, qkv
    biases) and, for each drawn leaf of 256 or more elements, a standard
    deviation within 10 % of the JAX draw's (the sampling error at 256
    elements is about 5 %)."""
    _, cfg = cfgs(arch, "bfloat16")
    own = leaves(T.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    carried = leaves(jax_weights(arch)[1])
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in carried.items()}
    for path, x in own.items():
        y = carried[path]
        assert x.dtype == torch.float32, path
        if bool((y == y.flatten()[0]).all()):
            assert torch.equal(x, y), path
        elif y.numel() >= 256:
            ratio = float(x.std()) / float(y.std())
            assert 0.9 < ratio < 1.1, (path, ratio)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_and_aux_match_jax(arch, dtype):
    """Teacher-forced logits (the vlm image prefix included) and, for
    the moe family, the load-balance aux summed over the layers."""
    j_cfg, cfg = cfgs(arch, dtype)
    jp, p = jax_weights(arch)
    batch = batch_for(cfg, 1)
    got, aux = T.forward_logits(p, cfg, batch)
    want, j_aux = j_T.forward_logits(jp, j_cfg, jax_batch(batch))
    moe = cfg.family == "moe"
    assert_close(got, want, dtype, moe=moe)
    assert set(aux) == set(j_aux) == (
        {"lb_loss", "router_z"} if moe else set())
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for k in aux:
        w = float(j_aux[k])
        assert abs(float(aux[k]) - w) <= tol * abs(w), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    """prefill (the vlm image prefix, the encdec encoder) then two decode
    steps: logits, the cache's keys, shapes and dtypes, and at float32
    its values."""
    cfg, (out, cache), (j_out, j_cache) = run_both(arch, dtype)
    for lg, j_lg in zip(out, j_out):
        assert_close(lg, j_lg, dtype, moe=cfg.family == "moe")
    assert set(cache) == set(j_cache)
    for k in cache:
        assert tuple(cache[k].shape) == j_cache[k].shape, k
        assert str(cache[k].dtype).split(".")[-1] == str(j_cache[k].dtype), k
        if dtype == "float32":
            assert_close(cache[k], j_cache[k], "float32")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_init_cache_matches_jax(arch, kv):
    """Keys, shapes and dtypes, zero-filled; int8 for the dense and vlm
    families only (the others keep their dtype, as in JAX)."""
    j_cfg, cfg = cfgs(arch, "bfloat16", kv_cache_dtype=kv)
    got = T.init_cache(cfg, 3, 40, "cpu")
    want = j_T.init_cache(j_cfg, 3, 40)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    assert (got["k"].dtype == torch.int8) == (
        kv == "int8" and cfg.family in ("dense", "vlm"))
