"""The arithmetic of the ssd kernel (csrc/ssd.cu), on the CPU, against the
plain versions `ref.ssd` (the sequential scan) and `ref.ssd_chunked`.

The kernel walks the sequence in tiles of min(chunk, 64) steps, one block
for each (batch, head, slice of PB head-dim columns), and keeps the state
S (PB, N) in float32 across the tiles. `kernel_model` below is that
arithmetic in plain torch: a model for this test that runs on no path. It
rounds where the kernel rounds and accumulates in float32:

- bfloat16: C, B and X are exact. The decayed scores (C B^T) * L and the
  state in the state read C S^T are each rounded once to bf16: both reach
  y alone. The decayed X of the state update is split into hi + lo bf16
  and both products are taken, so the state keeps ~16 bits a term.
- float32 (3xTF32): every operand x is split into hi = tf32(x) and lo =
  tf32(x - hi), and a product is lo hi + hi lo + hi hi.

Tolerances are the kernel's: bf16 y within 1e-2 of max(1, max |plain|),
float32 y and every final state within 1e-5 (the JAX package's scan
tolerance). `ssd.work` is checked at the serving path's case.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd as ssd_k

QT, PB = 64, 32                       # the kernel's tile and slice widths
F32_TOL, BF16_TOL = 1e-5, 1e-2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, kind: str):
    rnd = tf32 if kind == "tf32" else (
        lambda v: v.to(torch.bfloat16).float())
    hi = rnd(x)
    return hi, rnd(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 a @ b: lo hi + hi lo + hi hi, float32 sums."""
    (ah, al), (bh, bl) = split(a, "tf32"), split(b, "tf32")
    return al @ bh + ah @ bl + ah @ bh


def kernel_model(x, a, b, c, chunk, state0=None):
    """y (x's dtype) and the final state (B, H, P, N) float32, computed as
    the kernel computes them."""
    bf16 = x.dtype == torch.bfloat16
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    qe = min(chunk, QT)
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    y = torch.zeros((bsz, t, h, p), dtype=torch.float32)
    s_out = torch.zeros((bsz, h, p, n), dtype=torch.float32)
    for bi in range(bsz):
        for hi in range(h):
            for p0 in range(0, p, PB):          # one block a slice
                ps = slice(p0, min(p, p0 + PB))
                s = (torch.zeros((ps.stop - p0, n)) if state0 is None
                     else state0[bi, hi, ps].float().clone())
                for t0 in range(0, t, qe):
                    rows = slice(t0, min(t, t0 + qe))
                    cum = torch.cumsum(af[bi, rows, hi], 0)
                    cc, bb, xx = cf[bi, rows], bf[bi, rows], xf[bi, rows, hi, ps]
                    lq = cum.shape[0]
                    mask = torch.ones((lq, lq), dtype=torch.bool).tril()
                    decay = torch.where(mask, torch.exp(cum[:, None]
                                                        - cum[None, :]),
                                        torch.zeros(()))
                    last = cum[-1]
                    dx = xx * torch.exp(last - cum)[:, None]
                    if bf16:
                        rnd = lambda v: v.to(torch.bfloat16).float()  # noqa
                        pm = rnd((cc @ bb.T) * decay)
                        yo = cc @ rnd(s).T
                        dh, dl = split(dx, "bf16")
                        upd = dh.T @ bb + dl.T @ bb
                        yd = pm @ xx
                    else:
                        pm = mm3(cc, bb.T) * decay
                        yo = mm3(cc, s.T)
                        upd = mm3(dx.T, bb)
                        yd = mm3(pm, xx)
                    y[bi, rows, hi, ps] = torch.exp(cum)[:, None] * yo + yd
                    s = s * torch.exp(last) + upd
                s_out[bi, hi, ps] = s
    return y.to(x.dtype), s_out


def rel_err(got, want) -> float:
    err = float((got.double() - want.double()).abs().max())
    return err / max(1.0, float(want.double().abs().max()))


def inputs(seed, bsz, t, h, p, n, dtype, a_kind="rand", s0_scale=None):
    rng = np.random.default_rng(seed)

    def rand(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x = rand((bsz, t, h, p)).to(dtype)
    a = {"rand": -rand((bsz, t, h), 0.5).abs(),
         "zero": torch.zeros((bsz, t, h)),
         "very negative": -50.0 - rand((bsz, t, h)).abs()}[a_kind]
    b, c = (rand((bsz, t, n), 0.3).to(dtype) for _ in range(2))
    s0 = None if s0_scale is None else rand((bsz, h, p, n), s0_scale)
    return x, a, b, c, s0


CASES = {  # label: ((B, T, H, P, N), chunk, a, state0 scale)
    "path widths": ((1, 256, 2, 64, 128), 128, "rand", None),
    "path widths, initial state": ((1, 256, 2, 64, 128), 128, "rand", 0.5),
    "ragged T": ((2, 150, 1, 64, 128), 128, "rand", None),
    "chunk 48, ragged": ((1, 100, 2, 40, 96), 48, "rand", 0.5),
    "a = 0": ((1, 256, 2, 64, 128), 128, "zero", 0.5),
    "a very negative": ((1, 192, 2, 64, 128), 128, "very negative", 0.5),
    "large initial state": ((1, 192, 2, 64, 128), 128, "rand", 100.0),
    "chunk 1": ((1, 40, 2, 64, 128), 1, "rand", 0.5),
    "P 1": ((2, 130, 2, 1, 128), 128, "rand", 0.5),
    "N 1": ((2, 130, 2, 64, 1), 128, "rand", 0.5),
    "T 1": ((3, 1, 2, 64, 128), 128, "rand", 0.5),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("label", list(CASES))
def test_kernel_model_matches_plain(label, dtype):
    dims, chunk, a_kind, s0_scale = CASES[label]
    x, a, b, c, s0 = inputs(3, *dims, dtype, a_kind, s0_scale)
    y, state = kernel_model(x, a, b, c, chunk, s0)
    assert y.dtype == dtype and state.dtype == torch.float32
    want_y, want_s = ref.ssd(x, a, b, c, s0)
    assert rel_err(y, want_y) <= (F32_TOL if dtype == torch.float32
                                  else BF16_TOL)
    assert rel_err(state, want_s) <= F32_TOL
    t = dims[1]
    if t % min(chunk, t) == 0:
        cy, cs = ref.ssd_chunked(x, a, b, c, chunk, s0)
        assert rel_err(state, cs) <= F32_TOL
        assert rel_err(y.float(), cy.float()) <= (
            F32_TOL if dtype == torch.float32 else BF16_TOL)


def test_single_bf16_products_would_miss_the_state_tolerance():
    """Why the update splits: one bf16 rounding of the decayed X (no lo
    term) puts the state past 1e-5, where hi + lo keeps it within."""
    x, a, b, c, _ = inputs(5, 1, 128, 1, 64, 128, torch.bfloat16)
    want = ref.ssd(x, a, b, c)[1][0, 0]
    cum = torch.cumsum(a[0, :, 0], 0)
    dx = x[0, :, 0].float() * torch.exp(cum[-1] - cum)[:, None]
    bb = b[0].float()
    hi, lo = split(dx, "bf16")
    assert rel_err(hi.T @ bb, want) > F32_TOL
    assert rel_err(hi.T @ bb + lo.T @ bb, want) <= F32_TOL


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                                1.0 + 2 ** -9, 1.0]


def test_work_at_the_path_case():
    """x (4, 512, 80, 64) bf16, b/c (4, 512, 128), chunk 128: the causal
    triangle and the state read and update, 4,713,349,120 multiply-adds
    (two operations each); x, y, a, b, c and the final state at their
    element sizes, 54,132,736 bytes."""
    ops, nbytes = ssd_k.work(4, 512, 80, 64, 128, 128, torch.bfloat16)
    assert ops == 2 * 4_713_349_120
    assert nbytes == 54_132_736


@pytest.mark.parametrize("t,chunk", [(300, 128), (100, 48), (7, 128),
                                     (5, 1)])
def test_work_counts_ragged_chunks_as_they_are(t, chunk):
    bsz, h, p, n = 2, 3, 16, 8
    macs = 0
    for t0 in range(0, t, chunk):
        q = min(chunk, t - t0)
        macs += q * (q + 1) // 2 * (n + p) + 2 * q * p * n
    ops, nbytes = ssd_k.work(bsz, t, h, p, n, chunk, torch.float32,
                             state0=True)
    assert ops == 2 * bsz * h * macs
    assert nbytes == 4 * (2 * bsz * t * h * p + bsz * t * h
                          + 2 * bsz * t * n + 2 * bsz * h * p * n)
