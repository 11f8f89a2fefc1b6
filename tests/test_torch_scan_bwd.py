"""The plain backward versions of the training path's kernels on the CPU
(`kernels/ref.py`: `rg_lru_bwd`, `ssd_bwd`, `flash_attn_bwd` at Dh 256
with the prefix and window masks), each held against torch autograd of
its plain forward, and, through the port's models, against `jax.grad` of
the JAX package's functions: `models/rglru.rglru_scan`,
`models/ssd.ssd_scan` and `models/attention.attend_full` (the JAX
`kernels/ref.py` attention has no window or prefix mask). A plain model
of the ssd backward kernel's chunked arithmetic (csrc/ssd_bwd.cu) is held
against `ref.ssd_bwd`. Inputs come from numpy. Tolerances, of each
gradient's max |reference|: 1e-5 against autograd of the same float32
forward (the sums run in another order), 1e-4 against JAX (another
forward: JAX's associative and chunked scans and its float32
attention), 1e-6 for the float64 model of the kernel against the
float32 plain version.
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


def chunked_bwd_model(x, a, b, c, dy, dstate, state0, qc):
    """The ssd backward kernel's arithmetic (csrc/ssd_bwd.cu) in float64:
    the chunk entry states from a forward walk, then per chunk, from the
    last, W = L o CB^T, R2 = L o dY X^T, G2 = W o dY X^T, dX, dB, dC, the
    gradient g of the chunk's running sum of a (G2's row sums less its
    column sums, the S0 and dS terms) summed from each step to the
    chunk's end, and dS carried to the chunk before."""
    bsz, t, h, p = x.shape
    x, a, b, c, dy = (v.double() for v in (x, a, b, c, dy))
    dx, da = torch.zeros_like(x), torch.zeros_like(a)
    dbh = torch.zeros((bsz, h, t, b.shape[-1]), dtype=torch.float64)
    dch = torch.zeros_like(dbh)
    ds0 = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float64)
    starts = list(range(0, t, qc))
    for bi in range(bsz):
        for hh in range(h):
            s = state0[bi, hh].double().clone()
            entry = []
            for t0 in starts:
                entry.append(s.clone())
                for i in range(t0, min(t, t0 + qc)):
                    s = s * torch.exp(a[bi, i, hh]) \
                        + torch.outer(x[bi, i, hh], b[bi, i])
            dS = dstate[bi, hh].double().clone()
            for k in reversed(range(len(starts))):
                t0 = starts[k]
                q = min(qc, t - t0)
                sl = slice(t0, t0 + q)
                X, DY, B, C = x[bi, sl, hh], dy[bi, sl, hh], b[bi, sl], \
                    c[bi, sl]
                cum = torch.cumsum(a[bi, sl, hh], 0)
                ecum, etail = torch.exp(cum), torch.exp(cum[-1] - cum)
                tri = torch.ones((q, q), dtype=torch.bool).tril()
                L = torch.exp(cum[:, None] - cum[None, :]) * tri
                W, R2 = L * (C @ B.T), L * (DY @ X.T)
                G2 = W * (DY @ X.T)
                dx[bi, sl, hh] = W.T @ DY + etail[:, None] * (B @ dS.T)
                t6 = X @ dS
                dbh[bi, hh, sl] = R2.T @ C + etail[:, None] * t6
                ev = etail * (B * t6).sum(1)
                t7 = DY @ entry[k]
                dch[bi, hh, sl] = R2 @ B + ecum[:, None] * t7
                g = G2.sum(1) - G2.sum(0) + ecum * (C * t7).sum(1) - ev
                g[-1] += ev.sum() + ecum[-1] * (dS * entry[k]).sum()
                da[bi, sl, hh] = torch.flip(torch.cumsum(torch.flip(g, [0]),
                                                         0), [0])
                dS = ecum[-1] * dS + (ecum[:, None] * DY).T @ C
            ds0[bi, hh] = dS
    return dx, da, dbh.sum(1), dch.sum(1), ds0


@pytest.mark.parametrize("t,qc", [(40, 16), (64, 64), (5, 64), (33, 1)])
def test_ssd_bwd_kernel_model_matches_plain(t, qc):
    x, a, b, c, s0, dy, ds = ssd_inputs(5, t=t)
    got = chunked_bwd_model(x, a, b, c, dy, ds, s0, qc)
    want = ref.ssd_bwd(*(v.double() for v in (x, a, b, c, dy, ds, s0)))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


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
