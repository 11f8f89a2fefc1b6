"""The arithmetic of the flash_attn backward kernel (csrc/flash_attn_bwd.cu),
on the CPU, against the plain version `ref.flash_attn_bwd`, jax.vjp of the
JAX package's plain attention, and the JAX package's Pallas kernel.

The kernel runs in two launches. The dq pass gives each warpgroup 64 query
rows and walks the key tiles once, with an online row max m and sum l (as
the forward does): P~ = exp2(S scale log2 e - m), dS~ = P~ (dP - D), dq~
rescaled when m grows, dq = dq~ scale / l at the end, and it writes lse =
m + log2 l (base 2) and D = rowsum(do o). The dk/dv pass gives a
warpgroup 64 keys and walks the group's q heads and each one's query
tiles in order: P^T = exp2(S^T scale log2 e - lse), dS^T = P^T (dP^T - D),
dv += P^T do, dk += dS^T q. At Dh 256 the dk/dv pass is two passes of
one launch (dk: S^T, dP^T, dk += dS^T q; dv: S^T, dv += P^T do), each
block one q head's keys, and a third launch sums each head's float32 dk
and dv over the kv head's group in head order; in float32 there the row
side stays raw and each k-step's A fragment is split hi / lo in
registers, the same split as the stored one, with 16-key and 16-query
column tiles. `kernel_model` below is that arithmetic in plain torch, a
model for this test that runs on no path:

- the tile walk of each pass, with the blocks' skipped (wholly masked)
  tiles under the window and prefix masks, and dk / dv summed over a kv
  head's group in the kernel's order (one accumulator walking the heads,
  or at Dh 256 each head's float32 partial, then their sum);
- float32 (3xTF32): every operand x split into hi = tf32(x) and lo =
  tf32(x - hi), a product lo hi + hi lo + hi hi; the register operands (P,
  dS) split the same way, and the products that contract over keys or
  queries read a transposed copy stored with its columns permuted within
  groups of 8 (2c at c, 2c + 1 at c + 4), through the tf32 A fragment's
  column order (c, c + 4 <- 2c, 2c + 1);
- bfloat16: the S products exact in float32, P and dS rounded to bf16
  before the products that take them, outputs rounded to bf16.

Tolerances are the kernel's: float32 within 1e-4 of max(1, max |want|),
bf16 within 1e-2. Inputs scaled x3 (scores ~30) are where one tf32 pass
misses 1e-4 and 3xTF32 must not.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as j_pallas
from repro.kernels import ref as j_ref
from repro.models import attention as j_attn
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ref

SRC = Path(fa.__file__).parent / "csrc" / "flash_attn_bwd.cu"
# the kernel's tiles (test_tile_constants_match_the_kernel_source)
ROWS = 64
DQ_BN_BF16, DQ_BN_F32, DKDV_BN_BF16, DKDV_BN_F32 = 64, 64, 64, 32
DQ_BN_F32_256, DKDV_BN_F32_256 = 16, 16
DQ_NWG, DKDV_NWG = 2, 2
F32_TOL, BF16_TOL = 1e-4, 1e-2
LOG2E = 1.4426950408889634


def plan(dq: bool, f32: bool, dh: int) -> tuple[int, int]:
    """(BN, NWG) of a pass: the column tile (keys in the dq pass, queries
    in the dk/dv pass) and the warpgroups of 64 rows a block, as `Cfg` in
    the kernel source."""
    dq256 = dq and not f32 and dh == 256      # one warpgroup, whole tiles
    nwg = 1 if (f32 and dh >= 128) or dq256 else DQ_NWG if dq else DKDV_NWG
    if f32 and dh == 256:                     # the row side split in registers
        return (DQ_BN_F32_256 if dq else DKDV_BN_F32_256), nwg
    bn = ((DQ_BN_F32 if f32 else DQ_BN_BF16) if dq
          else DKDV_BN_F32 if f32 else DKDV_BN_BF16)
    return bn // (2 if dh >= 128 and not dq256 else 1), nwg


def dq_walk(sq, skv, dh, f32, causal, window, prefix=0):
    """(query rows, key tile start, BN) of every step of the dq pass, per
    q head: a block of NWG warpgroups walks the key tiles from its first
    row's window to its last row's diagonal (or to the prefix, where that
    lies further)."""
    bn, nwg = plan(True, f32, dh)
    for b0 in range(0, sq, ROWS * nwg):
        kend = min(skv, max(b0 + ROWS * nwg, prefix)) if causal else skv
        kbeg = max(0, b0 - window + 1) // bn * bn if window > 0 else 0
        for w in range(nwg):
            rows = range(b0 + ROWS * w, min(sq, b0 + ROWS * (w + 1)))
            if len(rows):
                yield rows, [k0 for k0 in range(kbeg, kend, bn)], bn


def dkdv_walk(sq, skv, dh, f32, causal, window, prefix=0):
    """(key rows, query tile starts, BN) of every block of the dk/dv pass,
    per kv head: from the first key's diagonal (from query 0 if a key of
    the block lies in the prefix) to the last query whose window holds the
    block's last key."""
    bn, nwg = plan(False, f32, dh)
    for k0 in range(0, skv, ROWS * nwg):
        klast = min(skv, k0 + ROWS * nwg) - 1
        qbeg = k0 // bn * bn if causal and k0 >= prefix else 0
        qend = min(sq, klast + window) if causal and window > 0 else sq
        for w in range(nwg):
            keys = range(k0 + ROWS * w, min(skv, k0 + ROWS * (w + 1)))
            if len(keys):
                yield keys, list(range(qbeg, qend, bn)), bn


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def vt_col(j: int) -> int:
    """The column of element j in a transposed copy (csrc's vt_col)."""
    return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)


def frag_col(c: int) -> int:
    """The accumulator column that the tf32 A fragment's k-index c holds
    (registers a0..a3: columns c and c + 4 of a k-step of 8, packed from
    the accumulator's 2c and 2c + 1)."""
    return 8 * (c // 8) + (2 * (c % 8) if c % 8 < 4 else 2 * (c % 8 - 4) + 1)


def ss(a, b, f32, passes=3, dq_order=True):
    """a (H, M, D) times b (H, N, D)^T as the shared-memory products: bf16
    exact in float32; float32 lo hi + hi lo + hi hi, in the order each
    pass issues them (the dq pass A = q; the dk/dv pass A = k, the same
    values from the other side)."""
    if not f32:
        return a @ b.transpose(-1, -2)
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return ah @ bh.transpose(-1, -2)
    t1, t2 = al @ bh.transpose(-1, -2), ah @ bl.transpose(-1, -2)
    return (t1 + t2 if dq_order else t2 + t1) + ah @ bh.transpose(-1, -2)


def rs(frag, b, f32, passes=3, perm=vt_col):
    """frag (H, M, BN) in registers times b (H, BN, D) over the BN columns.
    bf16: frag rounded to bf16, b read as is (MN-major). float32: b's
    transposed copy stored with column perm(j) holding b's row j, read
    through the A fragment's column order, both split hi / lo."""
    if not f32:
        return bf16(frag) @ b
    # a ragged tile's missing columns are the kernel's zero-filled rows
    pad = -frag.shape[-1] % 8
    frag = torch.nn.functional.pad(frag, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    bn = frag.shape[-1]
    t = torch.empty(b.shape[0], b.shape[2], bn)
    t[:, :, [perm(j) for j in range(bn)]] = b.transpose(-1, -2)
    a = frag[:, :, [frag_col(c) for c in range(bn)]]
    (ah, al), (th, tl) = split(a), split(t)
    if passes == 1:
        return ah @ th.transpose(-1, -2)
    return al @ th.transpose(-1, -2) + ah @ tl.transpose(-1, -2) \
        + ah @ th.transpose(-1, -2)


def keep(qi, kj, causal, window, prefix=0):
    """The mask over query indices qi (rows) and key indices kj."""
    qi, kj = torch.as_tensor(qi)[:, None], torch.as_tensor(kj)[None, :]
    if not causal:
        return torch.ones(qi.shape[0], kj.shape[1], dtype=torch.bool)
    m = (kj <= qi) | (kj < prefix)
    return m & (kj > qi - window) if window else m


def kernel_model(q, k, v, o, do, causal=False, window=0, passes=3,
                 perm=vt_col, prefix=0, nsq=1, nspl=1):
    """(dq, dk, dv) in the inputs' dtype, computed as the kernel computes
    them; at Dh 256 each dq block's key walk in `nsq` contiguous parts
    (each part's dq~, row max m and sum l, combined in part order with
    weights exp2(m_i - max m)) and each dk/dv block's query walk in `nspl`
    (each part's float32 partial added in order), `fa.bwd_splits`."""
    f32 = q.dtype == torch.float32
    split_group = q.shape[2] == 256   # per-head partials, summed
    bh, sq, dh = q.shape
    nkv, skv = k.shape[:2]
    group = bh // nkv
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    sl2 = float(scale * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kq, vq = (x.repeat_interleave(group, 0) for x in (kf, vf))
    dsum = (dof * of).sum(-1)
    dq = torch.zeros(bh, sq, dh)
    lse = torch.zeros(bh, sq)
    ninf = torch.tensor(-math.inf)
    for rows, tiles, bn in dq_walk(sq, skv, dh, f32, causal, window,
                                   prefix):
        r = slice(rows.start, rows.stop)
        per = -(-len(tiles) // nsq) if split_group else max(1, len(tiles))
        stats = []                      # each part's (m, l, dq~)
        for i in range(nsq if split_group else 1):
            m = torch.full((bh, len(rows)), -math.inf)
            l = torch.zeros(bh, len(rows))
            acc = torch.zeros(bh, len(rows), dh)
            for k0 in tiles[i * per:(i + 1) * per]:
                c = slice(k0, min(skv, k0 + bn))
                s = ss(qf[:, r], kq[:, c], f32, passes)
                dp = ss(dof[:, r], vq[:, c], f32, passes)
                s = torch.where(keep(rows, range(c.start, c.stop), causal,
                                     window, prefix), s, ninf)
                x = s * sl2
                m_new = torch.maximum(m, x.amax(-1))
                mu = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - mu)
                m = m_new
                p = torch.exp2(x - mu[..., None])
                l = l * alpha + p.sum(-1)
                ds = p * (dp - dsum[:, r, None])
                acc = acc * alpha[..., None] + rs(ds, kq[:, c], f32, passes,
                                                  perm)
            stats.append((m, l, acc))
        if len(stats) == 1:
            m, l, acc = stats[0]
        else:
            # the combine: the parts in order, each weighted by exp2(m_i -
            # max m)
            m = torch.stack([st[0] for st in stats]).amax(0)
            mu = torch.where(m == -math.inf, 0.0, m)
            l = torch.zeros_like(m)
            acc = torch.zeros(bh, len(rows), dh)
            for mi, li, ai in stats:
                w = torch.exp2(mi - mu)
                l = l + w * li
                acc = acc + w[..., None] * ai
        dq[:, r] = acc * (scale / l.clamp_min(1e-30))[..., None]
        lse[:, r] = m + torch.log2(l)
    dk = torch.zeros(nkv, skv, dh)
    dv = torch.zeros(nkv, skv, dh)
    for keys, tiles, bn in dkdv_walk(sq, skv, dh, f32, causal, window,
                                     prefix):
        kr = slice(keys.start, keys.stop)
        dka = torch.zeros(nkv, len(keys), dh)
        dva = torch.zeros(nkv, len(keys), dh)
        per = -(-len(tiles) // nspl) if split_group else max(1, len(tiles))
        parts = [tiles[i * per:(i + 1) * per]
                 for i in range(nspl if split_group else 1)]
        for g in range(group):                  # q heads kvh * group + g
            hq = slice(g, bh, group)
            for part in parts:
                for q0 in part:
                    c = slice(q0, min(sq, q0 + bn))
                    st = ss(kf[:, kr], qf[hq, c], f32, passes,
                            dq_order=False)
                    dpt = ss(vf[:, kr], dof[hq, c], f32, passes,
                             dq_order=False)
                    kept = keep(range(c.start, c.stop), keys, causal,
                                window, prefix).T
                    p = torch.where(kept, torch.exp2(
                        st * sl2 - lse[hq, None, c]), 0.0)
                    dst = p * (dpt - dsum[hq, None, c])
                    dva = dva + rs(p, dof[hq, c], f32, passes, perm)
                    dka = dka + rs(dst, qf[hq, c], f32, passes, perm)
                if split_group:
                    # the part's float32 partial (dk scaled), added to the
                    # sum in head order, a head's parts in order, by the
                    # third launch
                    dk[:, kr] += dka * scale
                    dv[:, kr] += dva
                    dka, dva = torch.zeros_like(dka), torch.zeros_like(dva)
        if not split_group:
            dk[:, kr] = dka * scale
            dv[:, kr] = dva
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _inputs(bh, s, dh, group, dtype, scale=1.0, seed=0, causal=False,
            window=0, prefix=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(
        (rng.normal(size=sh) * sc).astype(np.float32)).to(dtype)
        for sh, sc in (((bh, s, dh), scale), ((bh // group, s, dh), scale),
                       ((bh // group, s, dh), 1.0), ((bh, s, dh), 1.0)))
    o = ref.flash_attn(q, k, v, causal=causal, window=window,
                       prefix_len=prefix)
    return q, k, v, o, do


def _err(got, want) -> float:
    w = want.double()
    return float((got.double() - w).abs().max()
                 / max(1.0, float(w.abs().max())))


def _check(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) <= tol, _err(g, w)


# (BH, S, Dh, group, dtype, causal, window, scale): the GPU cases' shapes at
# fewer heads (ragged S, S not a multiple of the tiles, every Dh in both
# dtypes, groups of 3 and 10, windows whose first key tile is partial,
# inputs x3)
F32, BF = torch.float32, torch.bfloat16
CASES = [
    (4, 100, 64, 1, F32, False, 0, 1.0),
    (2, 1, 64, 1, F32, False, 0, 1.0),
    (2, 63, 64, 1, F32, True, 0, 1.0),
    (2, 65, 64, 1, F32, False, 0, 1.0),
    (2, 300, 64, 1, F32, True, 50, 1.0),
    (6, 130, 32, 3, F32, True, 0, 1.0),
    (2, 70, 16, 1, F32, False, 0, 1.0),
    (2, 150, 128, 1, F32, False, 0, 1.0),
    (2, 140, 128, 1, F32, True, 37, 1.0),
    (10, 96, 32, 10, F32, True, 0, 1.0),
    (2, 200, 64, 1, F32, False, 0, 3.0),
    (2, 130, 64, 2, F32, True, 70, 3.0),
    (2, 100, 64, 1, BF, False, 0, 1.0),
    (3, 67, 128, 3, BF, True, 20, 1.0),
    (2, 70, 16, 1, BF, True, 0, 1.0),
    (2, 90, 32, 1, BF, False, 0, 1.0),
    (10, 65, 64, 10, BF, True, 0, 1.0),
]


def _id(case):
    bh, s, dh, group, dt, causal, window, scale = case
    return (f"{bh}x{s}x{dh}-g{group}-{str(dt)[6:]}"
            f"{'-causal' if causal else ''}{f'-w{window}' if window else ''}"
            f"{f'-x{scale:g}' if scale != 1 else ''}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_kernel_model_matches_plain(case):
    bh, s, dh, group, dt, causal, window, scale = case
    q, k, v, o, do = _inputs(bh, s, dh, group, dt, scale, causal=causal,
                             window=window)
    got = kernel_model(q, k, v, o, do, causal, window)
    want = ref.flash_attn_bwd(q, k, v, o, do, causal=causal, window=window)
    _check(got, want, F32_TOL if dt == F32 else BF16_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] == 0], ids=_id)
def test_kernel_model_matches_jax_vjp(case):
    """Against jax.vjp of the JAX package's plain attention (k and v
    repeated over the group, as its grouped heads are), in float32 on the
    inputs' values; the JAX reference has no window."""
    bh, s, dh, group, dt, causal, window, scale = case
    q, k, v, o, do = _inputs(bh, s, dh, group, dt, scale, causal=causal)
    got = kernel_model(q, k, v, o, do, causal)
    rep = (lambda x: jnp.repeat(x, group, axis=0))
    _, vjp = jax.vjp(lambda q, k, v: j_ref.flash_attn(q, rep(k), rep(v),
                                                      causal=causal),
                     *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(w))
            for w in vjp(jnp.asarray(do.float().numpy()))]
    _check(got, want, F32_TOL if dt == F32 else BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 256])
def test_kernel_model_on_the_pallas_forward(s, causal):
    """The backward of the JAX package's Pallas kernel (interpret mode),
    at tile-divisible shapes: jax.vjp does not differentiate through it
    (pallas_call's JVP rule fails on this kernel), so the model takes the
    Pallas kernel's output o, as the kernel takes the forward kernel's,
    and is held against jax.vjp of the plain attention."""
    q, k, v, _, do = _inputs(4, s, 32, 1, F32, causal=causal)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    with pytest.raises(Exception):
        jax.vjp(lambda q, k, v: j_pallas.flash_attn(
            q, k, v, causal=causal, interpret=True), jq, jk, jv)
    o = torch.from_numpy(np.array(j_pallas.flash_attn(
        jq, jk, jv, causal=causal, interpret=True)))
    got = kernel_model(q, k, v, o, do, causal)
    _, vjp = jax.vjp(lambda q, k, v: j_ref.flash_attn(q, k, v, causal=causal),
                     jq, jk, jv)
    want = [torch.from_numpy(np.array(w))
            for w in vjp(jnp.asarray(do.numpy()))]
    _check(got, want, F32_TOL)


@pytest.mark.parametrize("dh,causal,window", [(64, False, 0),
                                               (64, True, 70),
                                               (256, False, 0),
                                               (256, True, 40)])
def test_one_tf32_pass_misses_where_3xtf32_holds(dh, causal, window):
    """At inputs x3 (scores ~30) one tf32 product misses 1e-4, so the x3
    cases test the split; at Dh 256 too, where the row side's split is
    the registers'."""
    q, k, v, o, do = _inputs(2, 200 if dh == 64 else 100, dh, 1, F32, 3.0,
                             causal=causal, window=window)
    want = ref.flash_attn_bwd(q, k, v, o, do, causal=causal, window=window)
    _check(kernel_model(q, k, v, o, do, causal, window), want, F32_TOL)
    one = kernel_model(q, k, v, o, do, causal, window, passes=1)
    assert max(_err(g, w) for g, w in zip(one, want)) > F32_TOL


def test_unpermuted_transposed_copy_is_wrong():
    """The column permutation of the float32 transposed copies is what
    makes the register products right: stored in order, the gradients
    miss by far."""
    q, k, v, o, do = _inputs(2, 100, 32, 1, F32)
    want = ref.flash_attn_bwd(q, k, v, o, do, causal=False)
    bad = kernel_model(q, k, v, o, do, perm=lambda j: j)
    assert max(_err(g, w) for g, w in zip(bad, want)) > 1e-2


# phase 2's shapes in chip_smoke.py and the GPU tests': (S, Dh, group,
# dtype, causal, window)
PHASE2 = [(512, 64, 1, F32, False, 0), (100, 64, 1, F32, False, 0),
          (512, 64, 1, F32, True, 0), (300, 64, 1, F32, True, 50),
          (130, 32, 3, F32, True, 0), (200, 128, 1, F32, False, 0),
          (70, 16, 1, F32, False, 0), (512, 64, 1, BF, False, 0),
          (67, 128, 3, BF, True, 20), (1, 64, 1, F32, False, 0),
          (63, 64, 1, F32, True, 0), (65, 32, 1, BF, False, 0),
          (300, 128, 1, F32, True, 0), (512, 64, 10, F32, True, 0),
          (300, 64, 1, F32, True, 70), (200, 16, 2, BF, True, 50)]


@pytest.mark.parametrize("shape", PHASE2, ids=lambda c: "-".join(
    str(x)[6:] if isinstance(x, torch.dtype) else str(x) for x in c))
def test_walks_visit_every_kept_pair_once(shape):
    """Every (query, key) pair the mask keeps falls in exactly one visited
    tile pair of each pass, and no block of the dk/dv pass visits a query
    tile that no key of its own keeps."""
    s, dh, group, dt, causal, window = shape
    f32 = dt == F32
    mask = keep(range(s), range(s), causal, window).numpy()
    seen = np.zeros((s, s), dtype=int)
    for rows, tiles, bn in dq_walk(s, s, dh, f32, causal, window):
        for k0 in tiles:
            seen[rows.start:rows.stop, k0:min(s, k0 + bn)] += 1
    assert (seen[mask] == 1).all()
    seen = np.zeros((s, s), dtype=int)
    span = ROWS * plan(False, f32, dh)[1]       # a block's keys
    for keys, tiles, bn in dkdv_walk(s, s, dh, f32, causal, window):
        k0 = keys.start - keys.start % span
        for q0 in tiles:
            assert mask[q0:q0 + bn, k0:k0 + span].any()
            seen[q0:min(s, q0 + bn), keys.start:keys.stop] += 1
    assert (seen[mask] == 1).all()


# bf16 Dh 256 (the dq pass and the split dk / dv passes on the tensor
# cores, the group's per-head partials summed in head order): (BH, S,
# group, causal, window, prefix) at S off 64, group 1 and split groups, a
# window whose first key tile is partial, a prefix past a tile and = S
CASES_256 = [
    (4, 100, 1, True, 0, 0),
    (6, 150, 3, True, 0, 0),
    (4, 130, 2, True, 40, 0),
    (4, 140, 2, True, 0, 70),
    (4, 96, 4, True, 0, 96),
    (2, 77, 1, False, 0, 0),
]


def _id256(case):
    bh, s, group, causal, window, prefix = case
    return (f"{bh}x{s}-g{group}{'-causal' if causal else '-bidir'}"
            f"{f'-w{window}' if window else ''}"
            f"{f'-p{prefix}' if prefix else ''}")


@pytest.fixture(scope="module")
def dh256_cases():
    """Each case's inputs and the model's gradients (shared by the tests
    below: the model walks every tile in plain torch)."""
    out = {}
    for case in CASES_256:
        bh, s, group, causal, window, prefix = case
        ins = _inputs(bh, s, 256, group, BF, causal=causal, window=window,
                      prefix=prefix, seed=3)
        out[case] = ins, kernel_model(*ins, causal, window, prefix=prefix)
    return out


@pytest.mark.parametrize("case", CASES_256, ids=_id256)
def test_dh256_bf16_model_matches_plain(dh256_cases, case):
    bh, s, group, causal, window, prefix = case
    (q, k, v, o, do), got = dh256_cases[case]
    want = ref.flash_attn_bwd(q, k, v, o, do, causal=causal, window=window,
                              prefix_len=prefix)
    assert all(g.dtype == BF for g in got)
    _check(got, want, BF16_TOL)


@pytest.mark.parametrize("case", CASES_256, ids=_id256)
def test_dh256_bf16_model_matches_jax_vjp(dh256_cases, case):
    """Against jax.vjp of the JAX package's plain attention with the same
    mask (models/attention.py:attend_full: heads on axis 2, kv head h //
    group), on the inputs' float32 values."""
    bh, s, group, causal, window, prefix = case
    (q, k, v, o, do), got = dh256_cases[case]
    kind = ("bidir" if not causal else "local" if window
            else "prefix" if prefix else "causal")

    def heads(x):                          # (BH, S, Dh) -> (1, S, BH, Dh)
        return jnp.asarray(x.float().numpy().transpose(1, 0, 2)[None])
    _, vjp = jax.vjp(lambda q, k, v: j_attn.attend_full(
        q, k, v, mask_kind=kind, window=window, prefix_len=prefix),
        heads(q), heads(k), heads(v))
    want = [torch.from_numpy(np.array(w)[0].transpose(1, 0, 2))
            for w in vjp(heads(do))]
    _check(got, want, BF16_TOL)


@pytest.mark.parametrize("case", CASES_256, ids=_id256)
def test_dh256_walks_visit_every_kept_pair_once(case):
    """The bf16 Dh-256 plan's walks (the dq pass one warpgroup of 64 rows
    and 64-key tiles, the dk/dv passes two warpgroups of 64 keys and
    32-query tiles) under every mask: each kept (query, key) pair falls in
    exactly one visited tile of each pass, and no dk/dv block visits a
    query tile that no key of its own keeps."""
    bh, s, group, causal, window, prefix = case
    mask = keep(range(s), range(s), causal, window, prefix).numpy()
    seen = np.zeros((s, s), dtype=int)
    assert plan(True, False, 256) == (64, 1)
    assert plan(False, False, 256) == (32, 2)
    for rows, tiles, bn in dq_walk(s, s, 256, False, causal, window,
                                   prefix):
        for k0 in tiles:
            seen[rows.start:rows.stop, k0:min(s, k0 + bn)] += 1
    assert (seen[mask] == 1).all()
    seen = np.zeros((s, s), dtype=int)
    span = ROWS * plan(False, False, 256)[1]
    for keys, tiles, bn in dkdv_walk(s, s, 256, False, causal, window,
                                     prefix):
        k0 = keys.start - keys.start % span
        for q0 in tiles:
            assert mask[q0:q0 + bn, k0:k0 + span].any()
            seen[q0:min(s, q0 + bn), keys.start:keys.stop] += 1
    assert (seen[mask] == 1).all()


# float32 Dh 256 (the row side split in registers, 16-key and 16-query
# tiles, the group's per-head partials summed in head order): (BH, S,
# group, causal, window, prefix) at inputs x3 (scores ~30), S off the
# tiles, group 1 and split groups, a window whose first key tile is
# partial, a prefix past a tile and = S, bidirectional
CASES_256_F32 = [
    (4, 100, 1, True, 0, 0),
    (6, 75, 3, True, 0, 0),
    (4, 90, 2, True, 23, 0),
    (4, 84, 2, True, 0, 37),
    (2, 48, 1, True, 0, 48),
    (2, 53, 2, False, 0, 0),
]


@pytest.fixture(scope="module")
def dh256_f32_cases():
    out = {}
    for case in CASES_256_F32:
        bh, s, group, causal, window, prefix = case
        ins = _inputs(bh, s, 256, group, F32, 3.0, causal=causal,
                      window=window, prefix=prefix, seed=4)
        nsq, nspl = fa.bwd_splits(F32, bh, s, s, H100_SMS)
        out[case] = ins, kernel_model(*ins, causal, window, prefix=prefix,
                                      nsq=nsq, nspl=nspl)
    return out


H100_SMS = 132


def test_bwd_splits_at_the_timed_shapes():
    """The float32 Dh-256 walks' parts on an H100's 132 SMs: phase 2's
    (8, 300) has 40 dq blocks, split in 4, and 80 dk and dv blocks, in 3;
    the float32 twins of the path cases, 160 / 320 and 192 / 384 blocks,
    walk whole; bf16 never splits; the CPU cases above, a few blocks,
    take the most, 4. A split dq pass adds a fourth launch."""
    assert fa.bwd_splits(F32, 8, 300, 300, H100_SMS) == (4, 3)
    assert fa.bwd_splits(F32, 20, 512, 512, H100_SMS) == (1, 1)
    assert fa.bwd_splits(F32, 16, 768, 768, H100_SMS) == (1, 1)
    assert fa.bwd_splits(BF, 8, 300, 300, H100_SMS) == (1, 1)
    assert {fa.bwd_splits(F32, c[0], c[1], c[1], H100_SMS)
            for c in CASES_256_F32} == {(4, 4)}
    assert (fa.bwd_launches(256, 4), fa.bwd_launches(256, 1),
            fa.bwd_launches(64)) == (4, 3, 2)


@pytest.mark.parametrize("case", CASES_256_F32, ids=_id256)
def test_dh256_f32_model_matches_plain(dh256_f32_cases, case):
    bh, s, group, causal, window, prefix = case
    (q, k, v, o, do), got = dh256_f32_cases[case]
    want = ref.flash_attn_bwd(q, k, v, o, do, causal=causal, window=window,
                              prefix_len=prefix)
    assert all(g.dtype == F32 for g in got)
    _check(got, want, F32_TOL)


@pytest.mark.parametrize("case", CASES_256_F32, ids=_id256)
def test_dh256_f32_model_matches_jax_vjp(dh256_f32_cases, case):
    """Against jax.vjp of the JAX package's plain attention with the same
    mask (models/attention.py:attend_full), in float32."""
    bh, s, group, causal, window, prefix = case
    (q, k, v, o, do), got = dh256_f32_cases[case]
    kind = ("bidir" if not causal else "local" if window
            else "prefix" if prefix else "causal")

    def heads(x):                          # (BH, S, Dh) -> (1, S, BH, Dh)
        return jnp.asarray(x.numpy().transpose(1, 0, 2)[None])
    _, vjp = jax.vjp(lambda q, k, v: j_attn.attend_full(
        q, k, v, mask_kind=kind, window=window, prefix_len=prefix),
        heads(q), heads(k), heads(v))
    want = [torch.from_numpy(np.array(w)[0].transpose(1, 0, 2))
            for w in vjp(heads(do))]
    _check(got, want, F32_TOL)


@pytest.mark.parametrize("case", CASES_256_F32, ids=_id256)
def test_dh256_f32_walks_visit_every_kept_pair_once(case):
    """The float32 Dh-256 plan's walks (one warpgroup of 64 rows a block,
    16-key tiles in the dq pass and 16-query tiles in the dk and dv
    passes) under every mask."""
    bh, s, group, causal, window, prefix = case
    assert plan(True, True, 256) == (16, 1)
    assert plan(False, True, 256) == (16, 1)
    mask = keep(range(s), range(s), causal, window, prefix).numpy()
    seen = np.zeros((s, s), dtype=int)
    for rows, tiles, bn in dq_walk(s, s, 256, True, causal, window, prefix):
        for k0 in tiles:
            seen[rows.start:rows.stop, k0:min(s, k0 + bn)] += 1
    assert (seen[mask] == 1).all()
    seen = np.zeros((s, s), dtype=int)
    for keys, tiles, bn in dkdv_walk(s, s, 256, True, causal, window,
                                     prefix):
        for q0 in tiles:
            assert mask[q0:q0 + bn, keys.start:keys.stop].any()
            seen[q0:min(s, q0 + bn), keys.start:keys.stop] += 1
    assert (seen[mask] == 1).all()


def test_tile_constants_match_the_kernel_source():
    src = SRC.read_text()
    for name, want in (("ROWS", ROWS), ("DQ_BN_BF16", DQ_BN_BF16),
                       ("DQ_BN_F32", DQ_BN_F32),
                       ("DKDV_BN_BF16", DKDV_BN_BF16),
                       ("DKDV_BN_F32", DKDV_BN_F32),
                       ("DQ_BN_F32_256", DQ_BN_F32_256),
                       ("DKDV_BN_F32_256", DKDV_BN_F32_256),
                       ("DQ_NWG", DQ_NWG), ("DKDV_NWG", DKDV_NWG)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    assert "(j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)" in src
    # the Dh-256 plan: column tiles halved from Dh 128 (plan()), both
    # types on the tensor-core passes (one q head a dk/dv block: its
    # float32 partials, summed over the group); float32 with the row side
    # raw and split in registers, at its own column tiles
    assert "DQ256 = DQ && !F32 && DH == 256;" in src
    assert "RSPLIT = F32 && DH == 256;" in src
    assert "RSPLIT ? (DQ ? DQ_BN_F32_256 : DKDV_BN_F32_256)" in src
    assert "RSPLIT ? 2 : BIG || DQ256 ? 1 : DQ ? DQ_NWG : DKDV_NWG;" in src
    assert "(DH >= 128 && !DQ256 ? 2 : 1)" in src
    assert "fa_bwd256_dq_kernel" not in src
    assert "fa_bwd256_dkdv_kernel" not in src
    assert "enum Part { DKDV = 0, DK = 1, DV = 2 };" in src
    assert re.search(r"dkdv_pass<T, 256, DV, float>\(.*?bh / group, bh, 1,",
                     src, re.S)
    assert re.search(r"dkdv_pass<T, 256, DK, float>\(.*?bh / group, bh, 1,",
                     src, re.S)
    assert re.search(r"case 256: return run256<T>\(", src)


def test_bwd_work_at_the_path_case():
    """`bwd_work`, the bound's count: five products of Dh multiply-adds
    over the 512 x 512 pairs of 96 heads, 16.1 GFLOP; 25.2 MB in float32
    (q, k, v, o, do read and dq, dk, dv written once)."""
    ops, nbytes = fa.bwd_work((96, 512, 64), 96, torch.float32, False)
    assert ops == 10 * 96 * 512 * 512 * 64
    assert nbytes == 8 * 96 * 512 * 64 * 4
    assert ops / (495e12 / 3) * 1e3 == pytest.approx(0.0976, abs=5e-5)
