"""The rest of the model zoo in the port against the JAX package, on the
CPU, beside the per-architecture parity files (test_torch_zoo_qwen,
_dense, _moe and _multimodal, over zoo_parity.py): the configs' derived
counts for all eight new ids, the MoE FFN layer (dropless and dropping
capacity, bfloat16, the zero-weight tie swap, routing groups), the
attention fronts' prefix mask and cross-attention, and
`launch.serve.Server` for the dense and moe families against the JAX
`Server`. Weights and inputs, and the tolerances, as zoo_parity.py says.

The JAX `Server` runs with its sharding rules switched off (`rules_scope`
patched to a no-op context), as in test_torch_serve.py.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.models import attention as j_att
from repro.models import ffn as j_ffn
from repro.models import transformer as j_T
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.models import attention, ffn
from repro_torch.models import transformer as T
from zoo_parity import assert_close, batch_for, cfgs, jax_batch, jax_weights

# the JAX layers compiled once per static configuration (their eager
# op-by-op dispatch compiles each op and takes seconds a call)
j_moe_ffn = jax.jit(j_ffn.moe_ffn, static_argnums=(2, 3, 4, 5))
j_attend_full = jax.jit(j_att.attend_full,
                        static_argnames=("mask_kind", "prefix_len"))

ZOO = ["qwen2_0_5b", "qwen2_5_32b", "starcoder2_3b", "glm4_9b",
       "granite_moe_3b", "phi3_5_moe", "whisper_small", "paligemma_3b"]


@pytest.mark.parametrize("arch", ZOO)
def test_config_counts_match_jax(arch):
    """The copied config's derived counts (test_torch_serve.py holds its
    fields): param_count, active_param_count, the layer kinds and the
    family flags equal JAX's, full and smoke."""
    for smoke in (False, True):
        cfg, j_cfg = base.load_arch(arch, smoke), j_base.load_arch(arch, smoke)
        assert (cfg.param_count(), cfg.active_param_count(),
                cfg._layer_kinds(), cfg.attention_free, cfg.subquadratic) \
            == (j_cfg.param_count(), j_cfg.active_param_count(),
                j_cfg._layer_kinds(), j_cfg.attention_free,
                j_cfg.subquadratic)


def moe_inputs(seed, b, t, d, cfg):
    """A smoke MoE layer's weights (JAX-built) and activations."""
    jp = j_ffn.init_moe(jax.random.key(seed), d, cfg.d_expert,
                        cfg.n_experts, cfg.act, 1, cfg.n_shared_experts)
    jp = jax.tree.map(lambda a: a[0], jp)
    p = tree.to_device(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((b, t, d)) \
        .astype(np.float32)
    return jp, p, x


def routed_counts(x, p, top_k):
    """Tokens each expert is routed (top-k of the router's softmax)."""
    logits = torch.einsum("btd,de->bte", torch.from_numpy(x), p["router"])
    idx = torch.topk(torch.softmax(logits, -1), top_k, dim=-1).indices
    return torch.bincount(idx.flatten(), minlength=p["router"].shape[-1])


@pytest.mark.parametrize("moe_arch", ["granite_moe_3b", "phi3_5_moe"])
@pytest.mark.parametrize("cf,groups", [(4.0, 1), (1.0, 1), (1.0, 4)])
def test_moe_ffn_matches_jax(moe_arch, cf, groups):
    """moe_ffn alone, float32, against the JAX one: the smoke configs'
    dropless capacity factor 4.0, and 1.0, where experts drop tokens
    (checked: some expert is routed more tokens than its capacity),
    group-local routing at 4 groups; out within 1e-4 of max |JAX|, aux
    within 1e-5 relative."""
    cfg = base.load_arch(moe_arch, smoke=True)
    b, t = 4, 16
    jp, p, x = moe_inputs(7, b, t, cfg.d_model, cfg)
    got, aux = ffn.moe_ffn(torch.from_numpy(x), p, cfg.act, cfg.moe_top_k,
                           cf, groups)
    want, j_aux = j_moe_ffn(jnp.asarray(x), jp, cfg.act, cfg.moe_top_k,
                            cf, groups)
    assert_close(got, want, "float32")
    for k in ("lb_loss", "router_z"):
        assert abs(float(aux[k]) - float(j_aux[k])) <= \
            1e-5 * abs(float(j_aux[k])), k
    if cf == 1.0 and groups == 1:
        cap = ffn.capacity(b * t, cfg.moe_top_k, cfg.n_experts, cf)
        assert int(routed_counts(x, p, cfg.moe_top_k).max()) > cap


@pytest.mark.parametrize("moe_arch", ["granite_moe_3b", "phi3_5_moe"])
def test_moe_ffn_bf16_matches_jax(moe_arch):
    """The MoE layer in bfloat16 on equal inputs (the smoke config's
    capacity): within the bfloat16 tolerance of the JAX layer."""
    cfg = base.load_arch(moe_arch, smoke=True)
    jp, p, x = moe_inputs(11, 2, 16, cfg.d_model, cfg)
    got, _ = ffn.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), p, cfg.act,
                         cfg.moe_top_k, cfg.capacity_factor)
    want, _ = j_moe_ffn(jnp.asarray(x).astype(jnp.bfloat16), jp, cfg.act,
                        cfg.moe_top_k, cfg.capacity_factor, 1)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "bfloat16")


def test_moe_zero_weight_ties_do_not_matter(monkeypatch):
    """An expert routed fewer tokens than its capacity fills its spare
    slots with tokens of router weight exactly 0, tied; which of them
    `torch.topk` picks is unspecified (and differs from jax.lax.top_k).
    Picking others (the token order reversed before the top-k) must give
    a bitwise equal output."""
    cfg = base.load_arch("granite_moe_3b", smoke=True)
    b, t, cf = 4, 16, 1.5
    _, p, x = moe_inputs(3, b, t, cfg.d_model, cfg)
    cap = ffn.capacity(b * t, cfg.moe_top_k, cfg.n_experts, cf)
    assert int(routed_counts(x, p, cfg.moe_top_k).min()) < cap < b * t
    picks = {}

    def spy(tag, topk):
        def fn(w, c):
            vals, idx = topk(w, c)
            picks[tag] = idx.sort(-1).values
            return vals, idx
        return fn

    def reversed_topk(w, c):
        vals, idx = torch.topk(w.flip(-1), c, dim=-1)
        return vals, w.shape[-1] - 1 - idx

    xt = torch.from_numpy(x).to(torch.bfloat16)
    monkeypatch.setattr(ffn, "capacity_topk", spy("first", ffn.capacity_topk))
    first, _ = ffn.moe_ffn(xt, p, cfg.act, cfg.moe_top_k, cf)
    monkeypatch.setattr(ffn, "capacity_topk", spy("other", reversed_topk))
    other, _ = ffn.moe_ffn(xt, p, cfg.act, cfg.moe_top_k, cf)
    assert not torch.equal(picks["first"], picks["other"])
    assert torch.equal(first, other)


def test_moe_groups_invariance():
    """The JAX test_moe_groups_invariance counterpart: group-local
    routing is capacity-equivalent across group counts when capacity is
    dropless (granite smoke, batch 4 x 16, 1 vs 4 groups, within its
    5e-2 at bfloat16), and the port at 4 groups matches the JAX package
    at 4 groups in float32."""
    jp, p = jax_weights("granite_moe_3b")
    cfg = base.load_arch("granite_moe_3b", smoke=True)
    batch = batch_for(cfg, 5, b=4, s=16)
    lg1, _ = T.forward_logits(p, cfg, batch)
    lg4, _ = T.forward_logits(p, dataclasses.replace(cfg, moe_groups=4),
                              batch)
    assert float((lg1.float() - lg4.float()).abs().max()) < 5e-2
    j_cfg, cfg = cfgs("granite_moe_3b", "float32", moe_groups=4)
    got, _ = T.forward_logits(p, cfg, batch)
    want, _ = j_T.forward_logits(jp, j_cfg, jax_batch(batch))
    assert_close(got, want, "float32")


@pytest.mark.parametrize("s,prefix", [(40, 0), (40, 1), (40, 8), (40, 40),
                                      (40, 50), (130, 70)])
def test_attend_flash_prefix_matches_jax(s, prefix):
    """The kernel front's "prefix" mask (flash_attn's causal prefix; its
    plain version on the CPU) against the JAX package's attend_full:
    grouped kv (4 heads over 2, and over 1), prefix 0 (causal), 1, inside
    the sequence, equal to it and past it, and one past a 64-key tile at
    a length that is not a tile multiple; within 1e-5 of max(1, max
    |want|)."""
    rng = np.random.default_rng(s + prefix)
    for kv in (2, 1):
        q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
        k, v = (rng.standard_normal((2, s, kv, 16)).astype(np.float32)
                for _ in range(2))
        want = np.asarray(j_attend_full(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask_kind="prefix", prefix_len=prefix))
        got = attention.attend_flash(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask_kind="prefix", prefix_len=prefix).numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def test_cross_attention_front_matches_jax():
    """Cross-attention's kernel front: bidir with Sq != Skv (a 16-token
    decoder over 150 encoder frames), against attend_full."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 150, 4, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_attend_full(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask_kind="bidir"))
    got = attention.attend_flash(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 mask_kind="bidir").numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * max(
        1.0, float(np.abs(want).max()))


def _jax_server(monkeypatch, arch, max_len, max_new):
    monkeypatch.setattr(j_serve, "rules_scope",
                        lambda rules: contextlib.nullcontext())
    srv = j_serve.Server(j_serve.ServeConfig(arch=arch, max_len=max_len,
                                             max_new=max_new))
    srv.cfg = dataclasses.replace(srv.cfg, dtype="float32")
    return srv


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "granite_moe_3b"])
def test_server_matches_jax_token_for_token(monkeypatch, arch):
    """Server.run against the JAX Server at float32 smoke, the same
    weights and prompts: 6 requests on 4 slots (two prefill batches,
    left-padded prompts of 4 to 12 tokens), 5 new tokens each."""
    j_srv = _jax_server(monkeypatch, arch, max_len=24, max_new=5)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=rng.integers(4, 13))
               for _ in range(6)]
    want = j_srv.run([j_serve.Request(i, q) for i, q in enumerate(prompts)])
    srv = serve.Server(serve.ServeConfig(arch=arch, max_len=24, max_new=5),
                       device="cpu",
                       params=tree.to_device(
                           jax.tree.map(np.asarray, j_srv.params), "cpu"))
    srv.cfg = cfgs(arch, "float32")[1]
    kops.reset_fa_stats()
    got = srv.run([serve.Request(i, q) for i, q in enumerate(prompts)])
    assert got["outputs"] == want["outputs"]
    assert (got["requests"], got["tokens"]) == (want["requests"],
                                                want["tokens"]) == (6, 24)
    # on the CPU the prefill's attention takes the plain form, no kernel
    assert kops.fa_stats() == {"kernel": 0, "ref": 0}


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_small"])
def test_server_refuses_vlm_and_encdec(arch):
    """The JAX Server feeds only tokens and fails with a KeyError on
    these families; the port's Server says why, up front."""
    with pytest.raises(ValueError, match="patches|frames"):
        serve.Server(serve.ServeConfig(arch=arch), device="cpu")
    assert serve.ServeConfig().arch == "qwen2_0_5b"
