"""The port's scans and recurrent blocks against the JAX package's, on the
CPU: `kernels.ref.ssd` / `ssd_chunked` and `models.ssd` (Mamba-2), and
`kernels.ref.rg_lru` and `models.rglru` (RecurrentGemma's RG-LRU).

Inputs are made with numpy from a seed and go through both packages;
block weights are built by the JAX package and carried across with
`core.tree.to_device`. The JAX side runs its Pallas kernels in interpret
mode (`impl="interpret"`), its jnp oracles and its model functions.
Tolerance: the largest error within 1e-5 of max(1, max |want|) in
float32 (tests/test_kernels.py's convention for the same kernels), 2e-2
where the inputs are bfloat16 (tests/test_models.py's tolerance).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import rglru as j_rglru
from repro.models import ssd as j_ssd
from repro_torch.configs.base import load_arch
from repro_torch.core import tree
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import rglru, ssd

TOL, BF16_TOL = 1e-5, 2e-2
SSD_SHAPES = [(2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32),
              (2, 32, 1, 8, 8, 8)]            # tests/test_kernels.py:76-78
LRU_SHAPES = [(2, 64, 16), (1, 128, 32), (3, 32, 8)]


def rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def ssd_inputs(b, tt, h, p, n):
    return (rand(0, (b, tt, h, p)), -np.abs(rand(1, (b, tt, h), 0.2)),
            rand(2, (b, tt, n), 0.3), rand(3, (b, tt, n), 0.3))


def jparams(init, *args):
    return jax.tree.map(np.asarray, init(jax.random.key(0), *args))


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ref_ssd_matches_jax_oracle_and_interpret_kernel(shape):
    *dims, chunk = shape
    x, a, b, c = ssd_inputs(*dims)
    y, state = ref.ssd(t(x), t(a), t(b), t(c))
    assert_close(y, j_ref.ssd(x, a, b, c))
    assert_close(y, j_ops.ssd_chunked(x, a, b, c, chunk=chunk,
                                      impl="interpret"))
    _, j_state = j_ssd.ssd_scan(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(c), chunk=chunk)
    assert_close(state, j_state)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_state0", [False, True])
def test_ssd_scan_matches_jax(shape, with_state0):
    """y and the final state of the port's ssd_scan (the plain chunked
    scan on the CPU) against JAX's ssd_scan, and y against the Pallas
    kernel in interpret mode and the sequential oracle."""
    *dims, chunk = shape
    bsz, _, h, p, n = dims
    x, a, b, c = ssd_inputs(*dims)
    s0 = rand(4, (bsz, h, p, n), 0.5) if with_state0 else None
    kops.reset_ssd_stats()
    y, state = ssd.ssd_scan(t(x), t(a), t(b), t(c), chunk=chunk,
                            state0=None if s0 is None else t(s0))
    assert kops.ssd_stats() == {"kernel": 0, "ref": 1}
    j_y, j_state = j_ssd.ssd_scan(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(c), chunk=chunk,
                                  state0=None if s0 is None
                                  else jnp.asarray(s0))
    assert_close(y, j_y)
    assert_close(state, j_state)
    if s0 is None:
        assert_close(y, j_ops.ssd_chunked(x, a, b, c, chunk=chunk,
                                          impl="interpret"))
        assert_close(y, ref.ssd(t(x), t(a), t(b), t(c))[0])
    else:
        want_y, want_state = ref.ssd(t(x), t(a), t(b), t(c), t(s0))
        assert_close(y, want_y.numpy())
        assert_close(state, want_state.numpy())


def test_ssd_scan_bf16_matches_jax():
    """bfloat16 x, b and c (as ssd_block gives them), float32 arithmetic,
    y in bfloat16."""
    x, a, b, c = ssd_inputs(2, 64, 3, 8, 16)
    xb, bb, cb = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    y, state = ssd.ssd_scan(xb, t(a), bb, cb, chunk=16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    j_y, j_state = j_ssd.ssd_scan(*(jnp.asarray(v, jnp.bfloat16)
                                    for v in (x,)), jnp.asarray(a),
                                  jnp.asarray(b, jnp.bfloat16),
                                  jnp.asarray(c, jnp.bfloat16), chunk=16)
    assert_close(y, np.asarray(j_y, np.float32), BF16_TOL)
    assert_close(state, j_state, BF16_TOL)


def test_ssd_step_matches_jax():
    bsz, h, p, n = 2, 3, 8, 16
    x, a, b, c = ssd_inputs(bsz, 1, h, p, n)
    s0 = rand(5, (bsz, h, p, n))
    y, state = ssd.ssd_step(t(x), t(a), t(b), t(c), t(s0))
    j_y, j_state = j_ssd.ssd_step(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(c),
                                  jnp.asarray(s0))
    assert_close(y, j_y)
    assert_close(state, j_state)


@pytest.fixture(scope="module")
def mamba_cfg():
    import dataclasses
    return dataclasses.replace(load_arch("mamba2_2_7b", smoke=True),
                               dtype="float32")


@pytest.mark.parametrize("decode", [False, True])
def test_ssd_block_matches_jax(mamba_cfg, decode):
    cfg = mamba_cfg
    jp = jparams(j_ssd.init_ssd_block, cfg.d_model, 1, cfg.ssm_state,
                 cfg.ssm_expand, cfg.ssm_head_dim, cfg.conv_width)
    lp = {k: v[0] for k, v in tree.to_device(jp, "cpu").items()}
    jlp = {k: jnp.asarray(v[0]) for k, v in jp.items()}
    bsz, tt = 2, 1 if decode else 32
    x = rand(6, (bsz, tt, cfg.d_model))
    state = None
    if decode:
        st = ssd.init_ssd_state(bsz, cfg.d_model, cfg, torch.float32)
        state = (t(rand(7, st[0].shape)), t(rand(8, st[1].shape, 0.3)))
    out, (conv, s) = ssd.ssd_block(t(x), lp, cfg, state, decode)
    j_out, (j_conv, j_s) = j_ssd.ssd_block(
        jnp.asarray(x), jlp, cfg, None if state is None else
        tuple(jnp.asarray(v.numpy()) for v in state), decode)
    assert_close(out, j_out)
    assert_close(conv, j_conv)
    assert_close(s, j_s)


# ---------------------------------------------------------------------------
# rg_lru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", LRU_SHAPES)
def test_ref_rg_lru_matches_jax_oracle_and_interpret_kernel(shape):
    b, tt, d = shape
    a = 1 / (1 + np.exp(-rand(0, shape)))
    bb = rand(1, shape)
    kops.reset_lru_stats()
    got = kops.rg_lru_scan(t(a), t(bb))
    assert kops.lru_stats() == {"kernel": 0, "ref": 1}
    assert_close(got, j_ref.rg_lru(a, bb))
    assert_close(got, j_ops.rg_lru_scan(a, bb, impl="interpret",
                                        bt=min(32, tt) // 2))
    h0 = rand(2, (b, d))
    assert_close(ref.rg_lru(t(a), t(bb), t(h0)),
                 j_ref.rg_lru(jnp.asarray(a), jnp.asarray(bb),
                              jnp.asarray(h0)))


@pytest.fixture(scope="module")
def lru_params():
    cfg = load_arch("recurrentgemma_2b", smoke=True)
    jp = jparams(j_rglru.init_rglru_block, cfg.d_model, cfg.lru_width, 1,
                 cfg.conv_width)
    lp = {k: v[0] for k, v in tree.to_device(jp, "cpu").items()}
    jlp = {k: jnp.asarray(v[0]) for k, v in jp.items()}
    return cfg, lp, jlp


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(lru_params, with_h0):
    """The port's serial scan against JAX's associative scan: the same
    recurrence summed in another order, so allclose."""
    cfg, lp, jlp = lru_params
    u = rand(3, (2, 24, cfg.lru_width))
    h0 = rand(4, (2, cfg.lru_width)) if with_h0 else None
    y, h_last = rglru.rglru_scan(t(u), lp, None if h0 is None else t(h0))
    j_y, j_h = j_rglru.rglru_scan(jnp.asarray(u), jlp,
                                  None if h0 is None else jnp.asarray(h0))
    assert_close(y, j_y)
    assert_close(h_last, j_h)


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_jax(lru_params, decode):
    cfg, lp, jlp = lru_params
    bsz, tt = 2, 1 if decode else 20
    x = rand(5, (bsz, tt, cfg.d_model))
    state = None
    if decode:
        st = rglru.init_rglru_state(bsz, cfg.lru_width, cfg.conv_width,
                                    torch.float32)
        state = (t(rand(6, st[0].shape)), t(rand(7, st[1].shape)))
    out, (conv, h) = rglru.rglru_block(t(x), lp, state, decode)
    j_out, (j_conv, j_h) = j_rglru.rglru_block(
        jnp.asarray(x), jlp, None if state is None else
        tuple(jnp.asarray(v.numpy()) for v in state), decode)
    assert_close(out, j_out)
    assert_close(conv, j_conv)
    assert_close(h, j_h)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w, b = rand(0, (2, 9, 6)), rand(1, (4, 6)), rand(2, (6,))
    st = rand(3, (2, 3, 6)) if with_state else None
    y, new = rglru._causal_conv(t(x), t(w), t(b),
                                None if st is None else t(st))
    j_y, j_new = j_rglru._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b),
                                      None if st is None else jnp.asarray(st))
    assert_close(y, j_y)
    assert_close(new, j_new)


def test_init_blocks_match_jax_shapes():
    """The port's block initializers give the JAX package's keys, shapes
    and deterministic leaves (zeros, ones, the decay and Lambda grids)."""
    gen = torch.Generator().manual_seed(0)
    cfg = load_arch("recurrentgemma_2b", smoke=True)
    got = rglru.init_rglru_block(gen, cfg.d_model, cfg.lru_width, 2)
    want = jparams(j_rglru.init_rglru_block, cfg.d_model, cfg.lru_width, 2)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert_close(got["lam"], want["lam"])
    m = load_arch("mamba2_2_7b", smoke=True)
    got = ssd.init_ssd_block(gen, m.d_model, 2, m.ssm_state, m.ssm_expand,
                             m.ssm_head_dim, m.conv_width)
    want = jparams(j_ssd.init_ssd_block, m.d_model, 2, m.ssm_state,
                   m.ssm_expand, m.ssm_head_dim, m.conv_width)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_b"):
        assert_close(got[k], want[k])


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of src/repro_torch/ imports jax or repro."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    scanned = {str(p.relative_to(root)) for p in root.rglob("*.py")}
    # the zoo's configs and the modules that serve it are among them
    assert {f"configs/{a}.py" for a in (
        "qwen2_0_5b", "qwen2_5_32b", "starcoder2_3b", "glm4_9b",
        "granite_moe_3b", "phi3_5_moe", "whisper_small", "paligemma_3b")} \
        | {"models/ffn.py", "models/transformer.py", "models/attention.py",
           "launch/serve.py"} <= scanned
    offenders = [str(p.relative_to(root)) for p in root.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders
