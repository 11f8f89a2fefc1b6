"""The arithmetic of the mlp_softmax_attn backward kernels
(csrc/mlp_softmax_attn_bwd.cu), on the CPU, against the plain versions:
the port's `kernels.ref.mlp_softmax_attn_bwd` and `jax.vjp` of the JAX
package's materialized `repro.kernels.ref.mlp_softmax_attn`, the function
its in-vivo finetune differentiates.

The backward runs in two launches. The head pass gives each kv head a
thread-block cluster of C blocks (`msa.bwd_plan`): block r walks the
(q head of the group, 64-row query tile) work items r, r + C, ... and owns
key rows [r L, r L + L). Each block reduces its partial A = scale K^T W1
and U = W2 V over its key rows; the partials are summed in rank order, so
every block holds the same A and U. Per work item it forms Z, H, dZ and
dq, and accumulates dA, dU, du0 and db1 over its items in walk order;
those are summed in rank order too. Each block then writes dk and dv for
its key rows, and the kv head's partial rows of dw1, dw2 and db2 (rank 0
also db1) into a per-kv-head scratch row of `msa.bwd_scratch` floats. The
sum pass adds those rows over the heads: SUM_GROUPS groups of consecutive
heads, each summed in head order, then the groups in group order.
`model_bwd` below is that arithmetic in plain torch: a model for this
test that runs on no path. It follows the kernels' sums (rank order, walk
order, the zero-filled rows past Sq, head order), not the order of the
terms inside one block's products.

Tolerances, of max(1, max |want|):
- 1e-5 against `ref.mlp_softmax_attn_bwd` in float32. Both compute the
  same reassociated products; only the order of their float32 sums
  differs (a block's key slice, the ranks, the work items, the head
  groups), and those sums run over at most a few thousand terms.
- 1e-4 against `jax.vjp` of the materialized form, the tolerance the
  kernels are held to on the card. The materialized form sums over the S x
  S scores, not through A and U, so its float32 sums run over other terms
  in another order; the gradients reach hundreds at the path's scales.
- 1e-10 in float64 against the plain version in float64: the model's
  algebra, with the rounding taken away.
`msa.bwd_work` is checked against a count written out by hand at the
in-vivo path case.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.kernels import mlp_softmax_attn as msa
from repro_torch.kernels import ref

SRC = Path(msa.__file__).resolve().parent / "csrc" / "mlp_softmax_attn_bwd.cu"
SUM_GROUPS = 8           # head groups of the sum pass (the .cu's)
SMS = 132                # an H100's SMs, for the cluster plan
TOL_PLAIN, TOL_JAX, TOL_F64 = 1e-5, 1e-4, 1e-10


def inputs(bh, sq, skv, dh, hid, group=1, seed=0, dtype=np.float32):
    """q, k, v, w1, b1, w2, b2, do at chip_smoke.py phase 2's scales."""
    rng = np.random.default_rng(seed)

    def randn(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(dtype)
    return (randn((bh, sq, dh)), randn((bh // group, skv, dh)),
            randn((bh // group, skv, dh)), randn((skv, hid), 0.2),
            randn((hid,), 0.1), randn((hid, skv), 0.2), randn((skv,), 0.01),
            randn((bh, sq, dh)))


def rank_sum(xs):
    """x_0 + x_1 + ..., left to right."""
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    return s


def head_sum(part):
    """The sum pass over the rows of `part` (one a kv head): SUM_GROUPS
    groups of ceil(BHk / SUM_GROUPS) consecutive heads, each in head
    order, then the groups in group order."""
    bhk = part.shape[0]
    hc = -(-bhk // SUM_GROUPS)
    groups = []
    for g in range(SUM_GROUPS):
        s = torch.zeros_like(part[0])
        for h in range(min(bhk, g * hc), min(bhk, g * hc + hc)):
            s = s + part[h]
        groups.append(s)
    return rank_sum(groups)


def model_bwd(q, k, v, w1, b1, w2, b2, do):
    """(dq, dk, dv, dw1, db1, dw2, db2) in the kernels' order of sums."""
    bh, sq, dh = q.shape
    bhk, skv, _ = k.shape
    group, hid = bh // bhk, w1.shape[1]
    nc, slice_ = msa.bwd_plan(bhk, group, sq, skv, SMS)
    nq, scale = -(-sq // msa.BQ), dh ** -0.5
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    sw, ns4 = skv * hid, msa.bwd_scratch(skv, hid)
    part = torch.zeros((bhk, ns4), dtype=q.dtype)
    keys = [range(min(skv, r * slice_), min(skv, (r + 1) * slice_))
            for r in range(nc)]
    for kv in range(bhk):
        kh, vh = k[kv], v[kv]
        # (a) each block's partial A and U over its key rows, rank order
        a = rank_sum([kh[s.start:s.stop].T @ w1[s.start:s.stop] * scale
                      for s in keys])
        u = rank_sum([w2[:, s.start:s.stop] @ vh[s.start:s.stop]
                      for s in keys])
        # (b) each block's work items in walk order, tiles zero-padded
        sums = []
        for r in range(nc):
            da = torch.zeros((dh, hid), dtype=q.dtype)
            du = torch.zeros((hid, dh), dtype=q.dtype)
            du0 = torch.zeros(dh, dtype=q.dtype)
            db1 = torch.zeros(hid, dtype=q.dtype)
            for it in range(r, group * nq, nc):
                h, q0 = kv * group + it // nq, it % nq * msa.BQ
                n = min(sq, q0 + msa.BQ) - q0
                qt = torch.zeros((msa.BQ, dh), dtype=q.dtype)
                dot = torch.zeros((msa.BQ, dh), dtype=q.dtype)
                qt[:n], dot[:n] = q[h, q0:q0 + n], do[h, q0:q0 + n]
                z = qt @ a + b1
                hh = torch.relu(z)
                dz = (dot @ u.T) * (z > 0)
                dq[h, q0:q0 + n] = (dz @ a.T)[:n]
                da = da + qt.T @ dz
                du = du + hh.T @ dot
                du0 = du0 + dot.sum(0)
                db1 = db1 + dz.sum(0)
            sums.append((da, du, du0, db1))
        # (c) dA, dU, du0, db1 over the ranks, rank order
        da, du, du0, db1 = (rank_sum(list(x)) for x in zip(*sums))
        # (d) each block's key rows, and the head's partials
        for s in keys:
            j = slice(s.start, s.stop)
            dk[kv, j] = w1[j] @ da.T * scale
            dv[kv, j] = w2[:, j].T @ du + b2[j, None] * du0
            dw1 = kh[j] @ da * scale
            dw2 = du @ vh[j].T
            part[kv, :sw].view(skv, hid)[j] = dw1
            part[kv, sw:2 * sw].view(hid, skv)[:, j] = dw2
            part[kv, 2 * sw:2 * sw + skv][j] = vh[j] @ du0
        part[kv, 2 * sw + skv:2 * sw + skv + hid] = db1
    tot = head_sum(part)
    return (dq, dk, dv, tot[:sw].reshape(skv, hid),
            tot[2 * sw + skv:2 * sw + skv + hid],
            tot[sw:2 * sw].reshape(hid, skv), tot[2 * sw:2 * sw + skv])


def assert_close(got, want, tol):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), err


# (BH, Sq, Skv, Dh, hid, group): the in-vivo cases at BH 2 (phase 2's
# proxy, phase 1's), a ragged S, Sq != Skv both ways (one block streaming
# 600 keys), Sq 1024 (two items a block), Sq 1 (a cluster of one), hid 1
# and hid 64 at Dh 16 and 128, group 3 (a cluster walking three heads'
# tiles), group 4 with ragged tiles, 9 and 17 kv heads (the sum pass's
# head groups uneven), and 96 (clusters of 2, each block streaming its
# 150 keys twice, as at the in-vivo path)
CASES = {"path phase 2": (2, 512, 512, 64, 16, 1),
         "path phase 1": (2, 512, 512, 64, 2, 1),
         "ragged S": (3, 100, 100, 64, 5, 1),
         "Sq < Skv": (2, 64, 600, 128, 16, 1),
         "Sq > Skv": (2, 200, 70, 16, 3, 1),
         "Sq 1024": (1, 1024, 300, 64, 16, 1),
         "Sq 1": (2, 1, 9, 32, 4, 1),
         "Dh 16 hid 1": (2, 70, 70, 16, 1, 1),
         "Dh 128 hid 64": (2, 200, 200, 128, 64, 1),
         "group 3": (6, 130, 130, 32, 7, 3),
         "group 4 ragged": (8, 100, 257, 32, 16, 4),
         "9 kv heads": (9, 64, 64, 16, 3, 1),
         "17 kv heads Skv 1": (17, 65, 1, 16, 2, 1),
         "96 kv heads": (96, 512, 300, 16, 3, 1)}


def torch_inputs(case, seed=0, dtype=np.float32):
    return [torch.from_numpy(x) for x in inputs(*CASES[case], seed=seed,
                                                dtype=dtype)]


# 96 kv heads make 147,456 values of Z: in float32 a few land within
# rounding of 0, where the two orders of sums take different sides of
# relu's step and dZ differs by dH there. That case is checked in float64.
@pytest.mark.parametrize("case", [c for c in CASES if c != "96 kv heads"])
def test_model_matches_plain(case):
    args = torch_inputs(case)
    assert_close(model_bwd(*args), ref.mlp_softmax_attn_bwd(*args),
                 TOL_PLAIN)


@pytest.mark.parametrize("case", ["ragged S", "Sq > Skv", "Dh 16 hid 1",
                                  "group 3", "group 4 ragged",
                                  "17 kv heads Skv 1", "96 kv heads"])
def test_model_is_the_gradient_in_float64(case):
    args = torch_inputs(case, seed=1, dtype=np.float64)
    assert_close(model_bwd(*args), ref.mlp_softmax_attn_bwd(*args), TOL_F64)


def jax_grads(x, group):
    """jax.vjp of the JAX package's materialized MLP_sm attention, k and v
    repeated over the group as its in-vivo finetune sees them."""
    q, k, v, w1, b1, w2, b2, do = map(jnp.asarray, x)

    def f(q, k, v, w1, b1, w2, b2):
        return j_ref.mlp_softmax_attn(q, jnp.repeat(k, group, axis=0),
                                      jnp.repeat(v, group, axis=0), w1, b1,
                                      w2, b2)
    _, vjp = jax.vjp(f, q, k, v, w1, b1, w2, b2)
    dq, dk, dv, dw1, db1, dw2, db2 = vjp(do)
    return dq, dk, dv, dw1, db1, dw2, db2


@pytest.mark.parametrize("case", ["path phase 2", "path phase 1",
                                  "ragged S", "Sq < Skv", "Sq 1",
                                  "Dh 16 hid 1", "Dh 128 hid 64", "group 3"])
def test_model_matches_jax_vjp(case):
    x = inputs(*CASES[case], seed=2)
    want = jax_grads(x, CASES[case][5])
    assert_close(model_bwd(*map(torch.from_numpy, x)), want, TOL_JAX)


@pytest.mark.parametrize("case", ["ragged S", "group 3"])
def test_model_on_strided_views(case):
    """q, k and v as transposed views (as the clear engine passes k): the
    same gradients as from contiguous copies, within the plain version's
    tolerance."""
    args = torch_inputs(case, seed=3)
    views = [x.transpose(0, 1).contiguous().transpose(0, 1)
             for x in args[:3]]
    assert not any(x.is_contiguous() for x in views)
    got = model_bwd(*views, *args[3:])
    assert_close(got, model_bwd(*args), 0.0)
    assert_close(got, ref.mlp_softmax_attn_bwd(*views, *args[3:]),
                 TOL_PLAIN)


@pytest.mark.parametrize("bhk", [1, 8, 96])
@pytest.mark.parametrize("group", [1, 3, 12])
@pytest.mark.parametrize("sq", [1, 64, 100, 512, 1024])
@pytest.mark.parametrize("skv", [1, 9, 100, 450, 512])
def test_plan_visits_every_item_and_key_row_once(bhk, group, sq, skv):
    nc, slice_ = msa.bwd_plan(bhk, group, sq, skv, SMS)
    nq = -(-sq // msa.BQ)
    assert 1 <= nc <= msa.CLUSTER_MAX and nc <= group * nq
    # the largest power of two that fits the items and one wave of 2 SMs
    assert nc & (nc - 1) == 0
    assert nc == 1 or bhk * nc <= 2 * SMS
    assert 2 * nc > min(msa.CLUSTER_MAX, group * nq) \
        or bhk * 2 * nc > 2 * SMS
    rows = [j for r in range(nc)
            for j in range(r * slice_, min(skv, (r + 1) * slice_))]
    assert rows == list(range(skv))
    items = sorted(it for r in range(nc) for it in range(r, group * nq, nc))
    assert items == list(range(group * nq))
    assert sorted((it // nq, it % nq) for it in items) == \
        [(g, t) for g in range(group) for t in range(nq)]


def test_plan_at_the_in_vivo_cases():
    """96 kv heads (phase 2's proxy at batch 8) take clusters of 2, so the
    192 blocks run in one wave; 8 (phase 1's) take clusters of 8."""
    assert msa.bwd_plan(96, 1, 512, 512, SMS) == (2, 256)
    assert msa.bwd_plan(8, 1, 512, 512, SMS) == (8, 64)


def test_scratch_row_holds_every_partial():
    """A kv head's scratch row: dw1, dw2, db2 and db1 back to back, padded
    to 16 bytes."""
    assert msa.bwd_scratch(512, 16) == 2 * 512 * 16 + 512 + 16 == 16_912
    for skv, hid in ((1, 1), (70, 3), (9, 5), (600, 64)):
        ns4 = msa.bwd_scratch(skv, hid)
        assert ns4 % 4 == 0 and 0 <= ns4 - (2 * skv * hid + skv + hid) < 4


def test_tile_constants_match_the_kernel_source():
    src = SRC.read_text()
    for name, want in (("BQ", msa.BQ), ("CLUSTER_MAX", msa.CLUSTER_MAX),
                       ("HID_MAX", msa.HID_MAX),
                       ("SUM_GROUPS", SUM_GROUPS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    # the C entries the wrapper binds, and no other kernel beside them
    for fn in ("msa_bwd_heads_f32", "msa_bwd_heads_bf16", "msa_bwd_sum"):
        assert f'extern "C" int {fn}(' in src
    assert set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                          r"\s*(\w+)\(", src)) == \
        {"msa_bwd_heads_kernel", "msa_bwd_sum_kernel"}
    assert src.count("__global__") == 2
    assert not re.search(r"\batomic\w*\(|\bred\.", src)


def test_bwd_work_at_the_path_case():
    """In-vivo phase 2's (96, 512, 64), hid 16, float32: q, do, dq and k,
    v, dk, dv 7 x 96 x 512 x 64 float32; w1, w2 and their gradients 4 x
    512 x 16, b1, db1 2 x 16 and b2, db2 2 x 512 float32. Five products a
    q row (q A, do U^T, dZ A^T, H^T do, q^T dZ) and six a key row (A, U,
    dk, dw1, dw2, dv), 2 x 64 x 16 operations each."""
    nbytes, ops = msa.bwd_work(96, 1, 512, 512, 64, 16, torch.float32)
    assert nbytes == 7 * 96 * 512 * 64 * 4 + 2 * (2 * 512 * 16 + 16 + 512) \
        * 4 == 88_215_680
    assert ops == 2.0 * 11 * 96 * 512 * 64 * 16 == 1_107_296_256
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0263, abs=5e-5)
    assert ops / (495e12 / 3) * 1e3 < nbytes / 3.35e12 * 1e3
