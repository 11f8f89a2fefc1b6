"""The plain backward versions of the training path's kernels on the CPU
(`kernels/ref.py`: `rg_lru_bwd`, `ssd_bwd`, `flash_attn_bwd` at Dh 256
with the prefix and window masks), each held against torch autograd of
its plain forward, and, through the port's models, against `jax.grad` of
the JAX package's functions: `models/rglru.rglru_scan`,
`models/ssd.ssd_scan` and `models/attention.attend_full` (the JAX
`kernels/ref.py` attention has no window or prefix mask). Plain models
of the ssd backward kernel's chunked arithmetic (csrc/ssd_bwd.cu), bf16
and float32 (3xTF32), are held against `ref.ssd_bwd` and `jax.grad`.
Inputs come from numpy. Tolerances, of each gradient's max |reference|:
1e-5 against autograd of the same float32 forward (the sums run in
another order), 1e-4 against JAX (another forward: JAX's associative and
chunked scans and its float32 attention) and for the float32 kernel
model (the card's gate), 1e-6 for the float64 model of the kernel
against the float32 plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import rglru as j_rglru
from repro.models import ssd as j_ssd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import attention, rglru, ssd

AUTOGRAD_TOL, JAX_TOL = 1e-5, 1e-4


def rng_np(seed):
    return np.random.default_rng(seed)


def close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


# ---------------------------------------------------------------------------
# rg_lru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,fill", [
    ((2, 33, 5), "rand"), ((1, 1, 4), "rand"), ((2, 17, 3), "zero"),
    ((2, 17, 3), "one"), ((3, 130, 7), "gate")])
def test_rg_lru_bwd_matches_autograd(shape, fill):
    r = rng_np(1)
    a = {"rand": r.random(shape), "zero": np.zeros(shape),
         "one": np.ones(shape),
         "gate": np.exp(-8 * r.random(shape) * 0.7)}[fill]
    a = torch.tensor(a, dtype=torch.float32, requires_grad=True)
    b = torch.tensor(r.standard_normal(shape), dtype=torch.float32,
                     requires_grad=True)
    dh = torch.tensor(r.standard_normal(shape), dtype=torch.float32)
    h = ref.rg_lru(a, b)
    want = torch.autograd.grad(h, (a, b), dh)
    got = ref.rg_lru_bwd(a.detach(), h.detach(), dh)
    for g, w in zip(got, want):
        close(g, w, AUTOGRAD_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_grad_matches_jax(with_h0):
    """The port's recurrence (the `RgLru` Function, `ref.rg_lru_bwd` on
    the CPU) against jax.grad of the JAX package's associative scan, for
    the input, the gate weights and Lambda, and the initial state."""
    r = rng_np(2)
    bsz, t, lw = 2, 24, 8
    pn = {"w_a": r.standard_normal((lw, lw)) * 0.3,
          "b_a": r.standard_normal(lw) * 0.1,
          "w_x": r.standard_normal((lw, lw)) * 0.3,
          "b_x": r.standard_normal(lw) * 0.1,
          "lam": r.standard_normal(lw)}
    pn = {k: v.astype(np.float32) for k, v in pn.items()}
    u = r.standard_normal((bsz, t, lw)).astype(np.float32)
    h0 = r.standard_normal((bsz, lw)).astype(np.float32) if with_h0 else None
    wy = r.standard_normal((bsz, t, lw)).astype(np.float32)
    wl = r.standard_normal((bsz, lw)).astype(np.float32)

    def j_loss(u, p, h0):
        y, h = j_rglru.rglru_scan(u, p, h0)
        return jnp.sum(y * wy) + jnp.sum(h * wl)
    args = (jnp.asarray(u), {k: jnp.asarray(v) for k, v in pn.items()},
            None if h0 is None else jnp.asarray(h0))
    want = jax.grad(j_loss, argnums=(0, 1, 2) if with_h0 else (0, 1))(*args)

    tu = torch.tensor(u, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in pn.items()}
    th0 = None if h0 is None else torch.tensor(h0, requires_grad=True)
    kops.reset_lru_bwd_stats()
    y, h = rglru.rglru_scan(tu, tp, th0)
    loss = (y * torch.tensor(wy)).sum() + (h * torch.tensor(wl)).sum()
    ins = [tu] + [tp[k] for k in sorted(tp)] + ([th0] if with_h0 else [])
    got = torch.autograd.grad(loss, ins)
    assert kops.lru_bwd_stats() == {"kernel": 0, "ref": 1}
    close(got[0], want[0], JAX_TOL)
    for g, k in zip(got[1:1 + len(tp)], sorted(tp)):
        close(g, want[1][k], JAX_TOL)
    if with_h0:
        close(got[-1], want[2], JAX_TOL)


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------

def ssd_inputs(seed, bsz=2, t=40, h=3, p=4, n=5, decay="rand"):
    r = rng_np(seed)
    a = {"rand": -r.random((bsz, t, h)) * 0.5,
         "none": np.zeros((bsz, t, h)),
         "underflow": -50.0 - r.random((bsz, t, h))}[decay]
    return [torch.tensor(v, dtype=torch.float32) for v in (
        r.standard_normal((bsz, t, h, p)), a, r.standard_normal((bsz, t, n)),
        r.standard_normal((bsz, t, n)), r.standard_normal((bsz, h, p, n)),
        r.standard_normal((bsz, t, h, p)), r.standard_normal((bsz, h, p, n)))]


@pytest.mark.parametrize("decay,state0,dstate,dtype", [
    ("rand", False, False, torch.float32), ("rand", True, True, torch.float32),
    ("none", True, False, torch.float32),
    ("underflow", False, True, torch.float32),
    ("rand", True, True, torch.bfloat16)])
def test_ssd_bwd_matches_autograd(decay, state0, dstate, dtype):
    x, a, b, c, s0, dy, ds = ssd_inputs(3, decay=decay)
    x, b, c = (v.to(dtype).requires_grad_() for v in (x, b, c))
    a.requires_grad_()
    s0 = (s0 * 100).requires_grad_() if state0 else None
    ins = [v for v in (x, a, b, c, s0) if v is not None]
    y, s = ref.ssd(x, a, b, c, state0=s0)
    loss = (y * dy).sum() + ((s * ds).sum() if dstate else 0)
    want = torch.autograd.grad(loss, ins)
    got = ref.ssd_bwd(x.detach(), a.detach(), b.detach(), c.detach(), dy,
                      ds if dstate else None,
                      None if s0 is None else s0.detach())
    assert got[0].dtype == dtype and got[2].dtype == dtype
    assert (got[4] is None) == (s0 is None)
    for g, w in zip([v for v in got if v is not None], want):
        close(g.float(), w.float(), AUTOGRAD_TOL)


@pytest.mark.parametrize("state0,chunk", [(False, 8), (True, 8), (True, 1)])
def test_ssd_scan_grad_matches_jax(state0, chunk):
    """The port's scan (the `SsdScan` Function: the plain chunked forward,
    `ref.ssd_bwd` backward) against jax.grad of the JAX package's chunked
    scan, with the final state's gradient and, if given, the initial
    state's."""
    x, a, b, c, s0, dy, ds = ssd_inputs(4, t=32)
    vals = [x, a, b, c] + ([s0] if state0 else [])

    def j_loss(*v):
        y, s = j_ssd.ssd_scan(*v[:4], chunk=chunk,
                              state0=v[4] if state0 else None)
        return jnp.sum(y * dy.numpy()) + jnp.sum(s * ds.numpy())
    want = jax.grad(j_loss, argnums=tuple(range(len(vals))))(
        *[jnp.asarray(v.numpy()) for v in vals])
    tv = [v.clone().requires_grad_() for v in vals]
    kops.reset_ssd_bwd_stats()
    y, s = ssd.ssd_scan(*tv[:4], chunk=chunk,
                        state0=tv[4] if state0 else None)
    got = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), tv)
    assert kops.ssd_bwd_stats() == {"kernel": 0, "ref": 1}
    for g, w in zip(got, want):
        close(g, np.asarray(w), JAX_TOL)


def _bf(v):
    """Round to bfloat16, keeping the dtype (the kernel's bf16 operands)."""
    return v.to(torch.bfloat16).to(v.dtype)


def _hi_lo(v):
    """The kernel's hi + lo split: two bf16 values whose sum keeps ~16
    bits of v."""
    hi = _bf(v)
    return hi, _bf(v - hi)


SSD_QT, SSD_HG = 64, 5          # csrc/ssd_bwd.cu: QT, HG


def ssd_bwd_model(x, a, b, c, dy, dstate, state0, rounding=True,
                  hi_lo=True):
    """The bf16 ssd backward kernel's arithmetic (csrc/ssd_bwd.cu), in
    chunks of SSD_QT steps, as a plain model for this test (it runs on no
    path). The state pass: S0 of each chunk from the forward chain S <-
    e^{cum_last} S + B^T (etail o X), dS leaving each chunk from the
    backward chain dS <- e^{cum_last} dS + (ecum o dY)^T C, the scaled
    operand split hi + lo and both products summed in float32, each chain
    value stored as a hi + lo bf16 image. The chunk pass, per (batch,
    chunk, head): W = L o C B^T, R2 = L o dY X^T and G2 = W o dY X^T in
    float32 (exact products of bf16 values), dX = bf16(W)^T dY + etail o
    (B dS_hi^T), dB += bf16(R2)^T C + etail o (X dS), dC += bf16(R2) B +
    ecum o (dY S0), the images' hi + lo in the last two; da from G2's row
    and column sums, the S0 and e terms and <dS, S0>. dB and dC sum over
    the heads in groups of SSD_HG, then over the groups, in order; dX, dB
    and dC come back in bf16. With `rounding` False every value is float64
    and nothing rounds: the algebra alone; with `hi_lo` False every hi +
    lo split keeps its hi part only."""
    dt = torch.float32 if rounding else torch.float64
    rnd = _bf if rounding else (lambda v: v)
    if not rounding:
        def split(v):
            return v, torch.zeros_like(v)
    elif hi_lo:
        split = _hi_lo
    else:
        def split(v):
            return _bf(v), torch.zeros_like(v)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    x, a, b, c, dy = (v.to(dt) for v in (x, a, b, c, dy))
    starts = list(range(0, t, SSD_QT))
    nc = len(starts)

    def chunk(bi, k, hh):
        sl = slice(starts[k], min(t, starts[k] + SSD_QT))
        cum = torch.cumsum(a[bi, sl, hh], 0)
        return (sl, cum, torch.exp(cum), torch.exp(cum[-1] - cum),
                torch.exp(cum[-1]))

    # the state pass: the chain values as hi + lo images
    s0_img = torch.zeros((bsz, h, nc, p, n), dtype=dt)
    ds_img = torch.zeros_like(s0_img)
    ds_hi = torch.zeros_like(s0_img)
    ds0 = torch.zeros((bsz, h, p, n), dtype=dt)
    for bi in range(bsz):
        for hh in range(h):
            st = (torch.zeros((p, n), dtype=dt) if state0 is None
                  else state0[bi, hh].to(dt))
            for k in range(nc):
                hi, lo = split(st)
                s0_img[bi, hh, k] = hi + lo
                sl, cum, ecum, etail, decay = chunk(bi, k, hh)
                xh, xl = split(etail[:, None] * x[bi, sl, hh])
                st = decay * st + xh.T @ b[bi, sl] + xl.T @ b[bi, sl]
            g = (torch.zeros((p, n), dtype=dt) if dstate is None
                 else dstate[bi, hh].to(dt))
            for k in reversed(range(nc)):
                hi, lo = split(g)
                ds_img[bi, hh, k], ds_hi[bi, hh, k] = hi + lo, hi
                sl, cum, ecum, etail, decay = chunk(bi, k, hh)
                yh, yl = split(ecum[:, None] * dy[bi, sl, hh])
                g = decay * g + yh.T @ c[bi, sl] + yl.T @ c[bi, sl]
            ds0[bi, hh] = g

    # the chunk pass
    dx, da = torch.zeros_like(x), torch.zeros_like(a)
    ngr = -(-h // SSD_HG)
    dbg = torch.zeros((bsz, ngr, t, n), dtype=dt)
    dcg = torch.zeros_like(dbg)
    for bi in range(bsz):
        for k in range(nc):
            for gi in range(ngr):
                for hh in range(gi * SSD_HG, min(h, (gi + 1) * SSD_HG)):
                    sl, cum, ecum, etail, _ = chunk(bi, k, hh)
                    q = cum.shape[0]
                    X, DY, B, C = x[bi, sl, hh], dy[bi, sl, hh], b[bi, sl], \
                        c[bi, sl]
                    tri = torch.ones((q, q), dtype=torch.bool).tril()
                    L = torch.where(tri, torch.exp(cum[:, None]
                                                   - cum[None, :]), 0.0)
                    dyx = DY @ X.T
                    W, R2 = L * (C @ B.T), L * dyx
                    G2 = W * dyx
                    S0, dS = s0_img[bi, hh, k], ds_img[bi, hh, k]
                    bds = B @ ds_hi[bi, hh, k].T
                    dx[bi, sl, hh] = rnd(W).T @ DY + etail[:, None] * bds
                    xds, dys0 = X @ dS, DY @ S0
                    ev = etail * (B * xds).sum(1)
                    dbg[bi, gi, sl] += rnd(R2).T @ C + etail[:, None] * xds
                    dcg[bi, gi, sl] += rnd(R2) @ B + ecum[:, None] * dys0
                    g = (G2.sum(1) - G2.sum(0) + ecum * (C * dys0).sum(1)
                         - ev)
                    g[-1] += ev.sum() + ecum[-1] * (dS * S0).sum()
                    da[bi, sl, hh] = torch.flip(
                        torch.cumsum(torch.flip(g, [0]), 0), [0])
    db, dc = dbg.sum(1), dcg.sum(1)
    out = (dx, db, dc) if not rounding else tuple(
        v.to(torch.bfloat16) for v in (dx, db, dc))
    return out[0], da, out[1], out[2], (None if state0 is None else ds0)


@pytest.mark.parametrize("t,h,p,n,decay", [
    (40, 3, 4, 5, "rand"), (64, 7, 16, 8, "rand"), (150, 6, 5, 7, "rand"),
    (130, 2, 8, 8, "rand"), (70, 2, 8, 6, "none")])
def test_ssd_bwd_kernel_model_matches_plain(t, h, p, n, decay):
    """The kernel's decomposition (chunk-parallel products, the state
    pass's chains, dB and dC in head groups) without rounding, in float64,
    against the plain step-by-step backward in float64: within 1e-6 of
    each gradient's max |plain|. T off the chunk, heads off the group, a
    head dim and state off the tiles, absent decays. (Decays that
    underflow leave da ~1e-21, which the chunked form's row and column
    sums of G2 lose against their O(1) diagonal: the card's gate holds
    them within 1e-2 of max(1, max |plain|).)"""
    x, a, b, c, s0, dy, ds = ssd_inputs(5, t=t, h=h, p=p, n=n, decay=decay)
    got = ssd_bwd_model(x, a, b, c, dy, ds, s0, rounding=False)
    want = ref.ssd_bwd(*(v.double() for v in (x, a, b, c, dy, ds, s0)))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


SSD_BF16_TOL = 1e-2     # the card's bf16 gate (chip_smoke.py BF16_TOL)


def _bf16_err(got, want) -> float:
    g, w = (v.detach().double().numpy() if torch.is_tensor(v)
            else np.array(v, dtype=np.float64) for v in (got, want))
    return float(np.abs(g - w).max() / max(1.0, float(np.abs(w).max())))


@pytest.fixture(scope="module")
def ssd_bf16_case():
    """bf16 inputs at Mamba-2's head and state widths, cut to 2 batch
    rows of 150 steps (T off the chunk) and 7 heads (off the group), the
    model's log decays, an initial state x10 and a final-state gradient;
    the kernel model with its roundings, and the plain float32 backward
    on the same bf16 values."""
    r = rng_np(8)
    bsz, t, h, p, n = 2, 150, 7, 64, 128
    x, b, c, dy = (torch.tensor(r.standard_normal(sh), dtype=torch.float32)
                   .to(torch.bfloat16) for sh in
                   ((bsz, t, h, p), (bsz, t, n), (bsz, t, n), (bsz, t, h, p)))
    a = torch.tensor(-0.1 - 2.0 * r.random((bsz, t, h)), dtype=torch.float32)
    s0 = torch.tensor(r.standard_normal((bsz, h, p, n)) * 10,
                      dtype=torch.float32)
    ds = torch.tensor(r.standard_normal((bsz, h, p, n)), dtype=torch.float32)
    ins = (x, a, b, c, dy, ds, s0)
    return ins, ssd_bwd_model(*ins), ref.ssd_bwd(*ins)


def test_ssd_bwd_kernel_model_bf16_matches_plain(ssd_bf16_case):
    """The model with the kernel's roundings (bf16 W and R2 into dX, dB,
    dC; the chains' and images' hi + lo; dX, dB, dC rounded at the end)
    against the plain backward on the same bf16 inputs, within the card's
    bf16 gate, 1e-2 of max(1, max |plain|), each gradient."""
    _, got, want = ssd_bf16_case
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert _bf16_err(g, w) <= SSD_BF16_TOL


def test_ssd_bwd_kernel_model_bf16_matches_jax(ssd_bf16_case):
    """The same against jax.grad of the JAX package's chunked scan
    (repro/models/ssd.py:ssd_scan, chunk 50) on the inputs' float32
    values, within the same gate."""
    (x, a, b, c, dy, ds, s0), got, _ = ssd_bf16_case
    vals = [v.float().numpy() for v in (x, a, b, c, s0)]

    def j_loss(x, a, b, c, s0):
        y, s = j_ssd.ssd_scan(x, a, b, c, chunk=50, state0=s0)
        return jnp.sum(y * dy.float().numpy()) + jnp.sum(s * ds.numpy())
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(v) for v in vals])
    for g, w in zip([got[0], got[1], got[2], got[3], got[4]], want):
        assert _bf16_err(g, np.asarray(w)) <= SSD_BF16_TOL


def test_ssd_bwd_chains_need_the_hi_lo_split(ssd_bf16_case):
    """The hi + lo splits (the chains' scaled operands, the images) are
    what keep da, a difference of sums that nearly cancel, well inside
    the gate: with each split cut to its hi part, da's error grows
    several-fold."""
    ins, got, want = ssd_bf16_case
    one = ssd_bwd_model(*ins, hi_lo=False)
    err_split, err_one = _bf16_err(got[1], want[1]), _bf16_err(one[1],
                                                                want[1])
    assert err_one > 3 * err_split


# ---------------------------------------------------------------------------
# the float32 ssd backward kernel (3xTF32)
# ---------------------------------------------------------------------------

SSD_HG_F32 = 10         # csrc/ssd_bwd.cu: HG_F
SSD_F32_TOL = 1e-4      # the card's float32 gate (chip_smoke.py TOL)


def _tf32(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, passes=3):
    """a @ b as the kernel's 3xTF32 products: each operand split hi =
    tf32(x), lo = tf32(x - hi), (lo hi + hi lo) + hi hi in float32; with
    `passes` 1, hi hi alone (one tf32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def ssd_bwd_model_f32(x, a, b, c, dy, dstate, state0, passes=3):
    """The float32 ssd backward kernel's arithmetic (csrc/ssd_bwd.cu,
    state_pass_f32 and chunk_pass_f32), in chunks of SSD_QT steps, as a
    plain model for this test (it runs on no path); every product 3xTF32
    (`_mm3`). The state pass: the chains S <- e^{cum_last} S + (etail o
    X)^T B and dS <- e^{cum_last} dS + (ecum o dY)^T C, each chunk's S0
    and dS kept as float32 images, and the dX term etail o (B dS^T). The
    chunk pass, per (batch, chunk, head): G = C B^T and D = dY X^T, W = L o
    G, R2 = L o D, G2 = W o D; e_s = sum_p X[s][p] Z[s][p] from the dX
    term Z; dS^T X^T (into dB^T scaled by etail) and S0^T dY^T (its S0
    terms, into dC^T scaled by ecum); dB^T
    += C^T R2, dC^T += B^T R2^T, dX += (dY^T W)^T; da from G2's row and
    column sums, the S0 and e terms and <dS, S0>. dB and dC sum over the
    heads in groups of SSD_HG_F32, then over the groups, in order."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    mm = (lambda u, v: _mm3(u, v, passes))
    starts = list(range(0, t, SSD_QT))
    nc = len(starts)

    def chunk(bi, k, hh):
        sl = slice(starts[k], min(t, starts[k] + SSD_QT))
        cum = torch.cumsum(a[bi, sl, hh], 0)
        return (sl, cum, torch.exp(cum), torch.exp(cum[-1] - cum),
                torch.exp(cum[-1]))

    s0_img = torch.zeros((bsz, h, nc, p, n))
    ds_img = torch.zeros_like(s0_img)
    zterm = torch.zeros_like(x)                 # the dX term etail o B dS^T
    dx = torch.zeros_like(x)
    ds0 = torch.zeros((bsz, h, p, n))
    for bi in range(bsz):
        for hh in range(h):
            st = (torch.zeros((p, n)) if state0 is None
                  else state0[bi, hh].clone())
            for k in range(nc):
                s0_img[bi, hh, k] = st
                sl, cum, ecum, etail, decay = chunk(bi, k, hh)
                st = decay * st + mm((etail[:, None] * x[bi, sl, hh]).T,
                                     b[bi, sl])
            gs = (torch.zeros((p, n)) if dstate is None
                  else dstate[bi, hh].clone())
            for k in reversed(range(nc)):
                ds_img[bi, hh, k] = gs
                sl, cum, ecum, etail, decay = chunk(bi, k, hh)
                zterm[bi, sl, hh] = etail[:, None] * mm(b[bi, sl], gs.T)
                dx[bi, sl, hh] = zterm[bi, sl, hh]
                gs = decay * gs + mm((ecum[:, None] * dy[bi, sl, hh]).T,
                                     c[bi, sl])
            ds0[bi, hh] = gs

    da = torch.zeros_like(a)
    ngr = -(-h // SSD_HG_F32)
    dbg = torch.zeros((bsz, ngr, t, n))
    dcg = torch.zeros_like(dbg)
    for bi in range(bsz):
        for k in range(nc):
            sl = slice(starts[k], min(t, starts[k] + SSD_QT))
            B, C = b[bi, sl], c[bi, sl]
            G = mm(C, B.T)
            for gi in range(ngr):
                dbt = torch.zeros((n, B.shape[0]))
                dct = torch.zeros_like(dbt)
                for hh in range(gi * SSD_HG_F32, min(h, (gi + 1) * SSD_HG_F32)):
                    _, cum, ecum, etail, _ = chunk(bi, k, hh)
                    q = cum.shape[0]
                    X, DY = x[bi, sl, hh], dy[bi, sl, hh]
                    S0, dS = s0_img[bi, hh, k], ds_img[bi, hh, k]
                    tri = torch.ones((q, q), dtype=torch.bool).tril()
                    L = torch.where(tri, torch.exp(cum[:, None]
                                                   - cum[None, :]), 0.0)
                    D = mm(DY, X.T)
                    W, R2 = L * G, L * D
                    G2 = W * D
                    qx = mm(dS.T, X.T)                  # (n, s)
                    # e_s = sum_p X[s][p] Z[s][p], Z the state pass's term
                    ev = (X * zterm[bi, sl, hh]).sum(1)
                    dbt = dbt + qx * etail[None, :]
                    rs0 = mm(S0.T, DY.T)                # (n, t)
                    g2 = ecum * (C.T * rs0).sum(0)
                    dct = dct + rs0 * ecum[None, :]
                    dbt = dbt + mm(C.T, R2)
                    dct = dct + mm(B.T, R2.T)
                    dx[bi, sl, hh] = dx[bi, sl, hh] + mm(DY.T, W).T
                    g = G2.sum(1) - G2.sum(0) + g2 - ev
                    g[-1] += ev.sum() + ecum[-1] * (dS * S0).sum()
                    da[bi, sl, hh] = torch.flip(
                        torch.cumsum(torch.flip(g, [0]), 0), [0])
                dbg[bi, gi, sl] = dbt.T
                dcg[bi, gi, sl] = dct.T
    return (dx, da, dbg.sum(1), dcg.sum(1),
            None if state0 is None else ds0)


def _f32_err(got, want) -> float:
    g, w = (np.asarray(v.detach().double()) if torch.is_tensor(v)
            else np.array(v, dtype=np.float64) for v in (got, want))
    return float(np.abs(g - w).max() / max(1.0, float(np.abs(w).max())))


def _ssd_f32_inputs(seed, bsz, t, h, p, n, decay):
    r = rng_np(seed)
    x, b, c, dy = (torch.tensor(r.standard_normal(sh), dtype=torch.float32)
                   for sh in ((bsz, t, h, p), (bsz, t, n), (bsz, t, n),
                              (bsz, t, h, p)))
    u = r.random((bsz, t, h))
    a = torch.tensor({"rand": -0.1 - 2.0 * u, "none": 0.0 * u,
                      "underflow": -50.0 - u}[decay], dtype=torch.float32)
    s0 = torch.tensor(r.standard_normal((bsz, h, p, n)) * 100,
                      dtype=torch.float32)
    ds = torch.tensor(r.standard_normal((bsz, h, p, n)), dtype=torch.float32)
    return x, a, b, c, dy, ds, s0


# (B, T, H, P, N, decay): Mamba-2's widths with T off the chunk and heads
# off the group of 10; P and N off 32; no decay; decays that underflow
SSD_F32_CASES = [(1, 150, 13, 64, 128, "rand"), (2, 77, 3, 5, 7, "rand"),
                 (1, 100, 4, 40, 96, "none"),
                 (1, 130, 3, 16, 32, "underflow")]


@pytest.fixture(scope="module")
def ssd_f32_cases():
    """Each case's inputs (an initial state x100 and a final-state
    gradient), the float32 kernel model and the plain backward."""
    out = {}
    for case in SSD_F32_CASES:
        ins = _ssd_f32_inputs(9, *case)
        out[case] = ins, ssd_bwd_model_f32(*ins), ref.ssd_bwd(*ins)
    return out


@pytest.mark.parametrize("case", SSD_F32_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_ssd_bwd_kernel_model_f32_matches_plain(ssd_f32_cases, case):
    """The float32 kernel's decomposition on 3xTF32 against the plain
    step-by-step backward, within the card's float32 gate, 1e-4 of max(1,
    max |plain|), each gradient."""
    _, got, want = ssd_f32_cases[case]
    for g, w in zip(got, want):
        assert _f32_err(g, w) <= SSD_F32_TOL, _f32_err(g, w)


def test_ssd_bwd_kernel_model_f32_matches_jax(ssd_f32_cases):
    """The same at Mamba-2's widths against jax.grad of the JAX package's
    chunked scan (repro/models/ssd.py:ssd_scan, chunk 50)."""
    (x, a, b, c, dy, ds, s0), got, _ = ssd_f32_cases[SSD_F32_CASES[0]]

    def j_loss(x, a, b, c, s0):
        y, s = j_ssd.ssd_scan(x, a, b, c, chunk=50, state0=s0)
        return jnp.sum(y * dy.numpy()) + jnp.sum(s * ds.numpy())
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(v.numpy()) for v in (x, a, b, c, s0)])
    for g, w in zip(got, want):
        assert _f32_err(g, np.asarray(w)) <= SSD_F32_TOL


def test_ssd_bwd_f32_one_tf32_pass_misses(ssd_f32_cases):
    """At Mamba-2's widths one tf32 product (hi hi alone) misses the
    1e-4 gate where 3xTF32 holds: the split is what the float32 kernel
    needs."""
    ins, got, want = ssd_f32_cases[SSD_F32_CASES[0]]
    one = ssd_bwd_model_f32(*ins, passes=1)
    assert max(_f32_err(g, w) for g, w in zip(got, want)) <= SSD_F32_TOL
    assert max(_f32_err(g, w) for g, w in zip(one, want)) > SSD_F32_TOL


def test_ssd_bwd_constants_match_the_kernel_source():
    """The model's chunk and head group, and the wrapper's scratch sizes,
    are the kernel's (csrc/ssd_bwd.cu)."""
    import re
    from pathlib import Path
    from repro_torch.kernels import ssd as ssd_k
    src = (Path(ssd_k.__file__).parent / "csrc" / "ssd_bwd.cu").read_text()
    for name, want in (("QT", SSD_QT), ("HG", SSD_HG), ("PM", 64),
                       ("NM", 128)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    m = re.search(r"constexpr int HG_F = (\d+);", src)
    assert m and int(m.group(1)) == SSD_HG_F32
    assert ssd_k.BWD_CHUNK == SSD_QT
    assert ssd_k.BWD_HEADS == {torch.bfloat16: SSD_HG,
                               torch.float32: SSD_HG_F32}
    # a chunk's S0 or dS image: bf16 hi and lo tile images, float32 raw
    assert ssd_k.BWD_IMAGE_BYTES == {torch.bfloat16: 2 * 64 * 128 * 2,
                                     torch.float32: 128 * 64 * 4}
    assert "using ImgT = Tile<PM, NM * 2>;" in src
    assert "using ImgF = Tile<NM, PM * 4>;" in src
    assert ssd_k.bwd_launches(torch.bfloat16) == 3
    assert ssd_k.bwd_launches(torch.float32) == 3
    assert "cuda_cores" not in src


# ---------------------------------------------------------------------------
# flash_attn at Dh 256, prefix and window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,dh,group,causal,window,prefix", [
    (4, 20, 256, 2, True, 0, 0), (4, 20, 256, 2, False, 0, 0),
    (4, 20, 256, 4, True, 6, 0), (4, 20, 256, 1, True, 0, 7),
    (2, 20, 256, 1, True, 0, 20), (2, 20, 256, 1, True, 0, 1),
    (6, 33, 64, 3, True, 0, 40), (2, 9, 16, 1, True, 0, 0)])
def test_flash_attn_bwd_matches_autograd(bh, s, dh, group, causal, window,
                                         prefix):
    r = rng_np(6)
    q, k, v = (torch.tensor(r.standard_normal(sh), dtype=torch.float32,
                            requires_grad=True)
               for sh in ((bh, s, dh), (bh // group, s, dh),
                          (bh // group, s, dh)))
    do = torch.tensor(r.standard_normal((bh, s, dh)), dtype=torch.float32)
    o = ref.flash_attn(q, k, v, causal=causal, window=window,
                       prefix_len=prefix)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attn_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                             do, causal=causal, window=window,
                             prefix_len=prefix)
    for g, w in zip(got, want):
        close(g, w, AUTOGRAD_TOL)


@pytest.mark.parametrize("mask_kind,window,prefix", [
    ("causal", 0, 0), ("local", 5, 0), ("prefix", 0, 6), ("bidir", 0, 0)])
def test_flash_attn_grad_matches_jax(mask_kind, window, prefix):
    """`FlashAttn` (the plain forward and `ref.flash_attn_bwd` on the CPU,
    through `attention.attend_flash`) against jax.grad of the JAX
    package's attend_full at Dh 256, two kv heads of group 2."""
    r = rng_np(7)
    bsz, s, h, kvh, dh = 2, 16, 4, 2, 256
    q, k, v, w = (r.standard_normal(sh).astype(np.float32)
                  for sh in ((bsz, s, h, dh), (bsz, s, kvh, dh),
                             (bsz, s, kvh, dh), (bsz, s, h, dh)))

    def j_loss(q, k, v):
        return jnp.sum(j_attn.attend_full(q, k, v, mask_kind=mask_kind,
                                          window=window,
                                          prefix_len=prefix) * w)
    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kops.reset_fa_bwd_stats()
    o = attention.attend_flash(tq, tk, tv, mask_kind=mask_kind,
                               window=window, prefix_len=prefix)
    got = torch.autograd.grad((o * torch.tensor(w)).sum(), (tq, tk, tv))
    assert kops.fa_bwd_stats() == {"kernel": 0, "ref": 1}
    for g, wt in zip(got, want):
        close(g, np.asarray(wt), JAX_TOL)
