"""The arithmetic of the entropy_head kernel (csrc/entropy_head.cu), on
the CPU, against the plain versions: the port's `kernels.ref.entropy_head`,
the JAX package's jnp oracle `repro.kernels.ref.entropy_head` and its
Pallas kernel in interpret mode (run as tests/test_torch_clear_kernels.py
runs it).

The kernel splits a row by `entropy_head.plan`: rows of V <= NARROW_V
take one thread each (the max, then one exp a column, in column order);
otherwise a row takes `threads` threads and `blocks` blocks (a cluster).
Its 16-byte vectors start at the row's first 16-byte boundary (row r
starts at byte base + r V size); the head before it and the tail after
the last whole vector are folded one element a thread by the first block
(head first); the body's vectors are cut into `blocks` contiguous shares,
and thread t of a block walks the vectors t, t + threads, ... of its
share in chunks of VECS: the chunk's max, one rescale of the running
(z, s), then one exp an element in order. The triples are merged in a
balanced tree in lane order over each warp, then over the row's warps,
then over the cluster's ranks. `kernel_model` below is that arithmetic
in plain torch, float32 (a model for this test that runs on no path);
it also counts how often each element is folded.

Tolerance: 1e-5 of max(1, max |want|), the kernel's tolerance on the
card (chip_smoke.py's EH_TOL).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import entropy_head as eh
from repro_torch.kernels import ref

TOL = 1e-5
NEG_INF = -1e30
SOURCE = Path(eh.__file__).parent / "csrc" / "entropy_head.cu"


def merge(p, q):
    """(m, z, s) of p's elements and q's, p's terms first."""
    mn = torch.maximum(p[0], q[0])
    a, b = torch.exp(p[0] - mn), torch.exp(q[0] - mn)
    return mn, p[1] * a + q[1] * b, p[2] * a + q[2] * b


def tree(t):
    """The balanced tree in lane order over the last dim (padded with the
    empty triple, which merges as an identity), as lane 0 of a warp's
    shuffles ends with it."""
    n = t[0].shape[-1]
    size = 1 << max(0, (n - 1).bit_length())
    pad = [torch.full(t[0].shape[:-1] + (size - n,), v) for v in
           (NEG_INF, 0.0, 0.0)]
    t = tuple(torch.cat([x, p], -1) for x, p in zip(t, pad))
    while t[0].shape[-1] > 1:
        even = tuple(x[..., 0::2] for x in t)
        odd = tuple(x[..., 1::2] for x in t)
        t = merge(even, odd)
    return tuple(x[..., 0] for x in t)


def entropy(t):
    z = torch.clamp(t[1], min=1e-30)
    return t[0] + torch.log(z) - t[2] / z


def kernel_model(x, size=4, base=0, route=None):
    """H (R,) float32 as the kernel computes it from logits x (R, V)
    (float32 values of elements of `size` bytes, the tensor at byte
    address `base`), and the count of folds of each element (R, V).
    `route` = (threads, blocks), `plan(R, V)` by default."""
    r, v = x.shape
    x = x.float()
    count = torch.zeros((r, v), dtype=torch.int64)
    tpr, nc = eh.plan(r, v) if route is None else route
    if tpr == 1:                          # one thread a row
        m = torch.full((r,), NEG_INF)
        for i in range(v):
            m = torch.maximum(m, x[:, i])
        z, s = torch.zeros(r), torch.zeros(r)
        for i in range(v):
            e = torch.exp(x[:, i] - m)
            z, s = z + e, s + x[:, i] * e
            count[:, i] += 1
        return entropy((m, z, s)), count
    n = 16 // size                        # elements a vector
    addr = base + torch.arange(r) * v * size
    head = torch.clamp((16 - addr % 16) % 16 // size, max=v)     # (R,)
    nvec = (v - head) // n
    tail = v - head - nvec * n
    per = (nvec + nc - 1) // nc
    rank = torch.arange(nc)
    v0 = torch.minimum(nvec[:, None], rank * per[:, None])       # (R, nc)
    v1 = torch.minimum(nvec[:, None], v0 + per[:, None])
    t = torch.arange(tpr)
    shape = (r, nc, tpr)
    acc = (torch.full(shape, NEG_INF), torch.zeros(shape), torch.zeros(shape))
    rows = torch.arange(r)[:, None, None].expand(shape)

    def fold_where(acc, mask, col):
        col = torch.where(mask, col, 0)
        xi = x[rows, col]
        new = merge(acc, (xi, torch.ones(shape), xi))
        count.index_put_((rows[mask], col[mask]),
                         torch.ones(int(mask.sum()), dtype=torch.int64),
                         accumulate=True)
        return tuple(torch.where(mask, a1, a0) for a0, a1 in zip(acc, new))

    first = (rank == 0)[None, :, None]
    acc = fold_where(acc, first & (t < head[:, None, None]),
                     t.expand(shape))
    acc = fold_where(acc, first & (t < tail[:, None, None]),
                     (head + nvec * n)[:, None, None] + t)
    j0 = v0[:, :, None] + t                                      # (R, nc, tpr)
    while True:
        live = j0 < v1[:, :, None]
        if not bool(live.any()):
            break
        cols, oks = [], []
        for u in range(eh.VECS):
            j = j0 + u * tpr
            ok = j < v1[:, :, None]
            for k in range(n):
                cols.append(torch.where(ok, head[:, None, None] + j * n + k,
                                        0))
                oks.append(ok)
        vals = [x[rows, c] for c in cols]
        cm = torch.full(shape, NEG_INF)
        for val, ok in zip(vals, oks):
            cm = torch.where(ok, torch.maximum(cm, val), cm)
        mn = torch.maximum(acc[0], cm)
        a = torch.exp(acc[0] - mn)
        z, s = acc[1] * a, acc[2] * a
        for val, ok, c in zip(vals, oks, cols):
            e = torch.exp(val - mn)
            z = torch.where(ok, z + e, z)
            s = torch.where(ok, s + val * e, s)
            count.index_put_((rows[ok], c[ok]),
                             torch.ones(int(ok.sum()), dtype=torch.int64),
                             accumulate=True)
        acc = tuple(torch.where(live, new, old)
                    for old, new in zip(acc, (mn, z, s)))
        j0 = j0 + eh.VECS * tpr
    lanes = tree(tuple(q.reshape(r, nc, tpr // 32, 32) for q in acc))
    warps = tree(lanes)                                          # (R, nc)
    return entropy(tree(warps)), count


def logits(shape, dtype=torch.float32, fill="randn", scale=3.0, seed=0):
    """(R, V) logits in `dtype` from numpy: N(0, scale^2), or rows each
    of one value ("equal")."""
    rng = np.random.default_rng(seed)
    if fill == "equal":
        x = np.repeat(rng.standard_normal((shape[0], 1)) * scale, shape[1], 1)
    else:
        x = rng.standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def assert_close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}

# (R, V), dtype, fill, logit scale, base address, route: chip_smoke.py's
# phase-2 cases cut in rows where the model would be slow (every row is
# its own: the vocab case's route at 8 rows covers both row alignments)
CASES = {
    "path (16, 2)": ((16, 2), torch.float32, "randn", 3.0, 0, None),
    "V 1": ((5, 1), torch.float32, "randn", 3.0, 0, None),
    "V 3": ((5, 3), torch.float32, "randn", 3.0, 0, None),
    "V 17, a warp a row": ((5000, 17), torch.float32, "randn", 3.0, 0,
                           None),
    "two rows a block": ((600, 100), torch.float32, "randn", 3.0, 0, None),
    "ragged (7, 1000)": ((7, 1000), torch.float32, "randn", 3.0, 0, None),
    "vocab route": ((8, 30522), torch.float32, "randn", 3.0, 0, (512, 1)),
    "V 30521": ((3, 30521), torch.float32, "randn", 3.0, 0, None),
    "R 1": ((1, 30522), torch.float32, "randn", 3.0, 0, None),
    "cluster of 4": ((16, 30522), torch.float32, "randn", 3.0, 0, None),
    "cluster of 8": ((4, 256000), torch.float32, "randn", 3.0, 0, None),
    "scale 1e4": ((16, 30522), torch.float32, "randn", 1e4, 0, None),
    "all equal": ((16, 30522), torch.float32, "equal", 3.0, 0, None),
    "bf16, odd stride": ((8, 30521), torch.bfloat16, "randn", 3.0, 0,
                         (512, 1)),
    "f16, odd stride": ((8, 30521), torch.float16, "randn", 3.0, 0,
                        (512, 1)),
    "bf16 cluster": ((4, 30521), torch.bfloat16, "randn", 3.0, 0, None),
    "f32 off a boundary": ((3, 1000), torch.float32, "randn", 3.0, 4, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_plain(case):
    shape, dtype, fill, scale, base, route = CASES[case]
    x = logits(shape, dtype, fill, scale)
    got, count = kernel_model(x, SIZE[dtype], base, route)
    assert bool((count == 1).all())
    assert_close(got, ref.entropy_head(x))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_jax_oracle(case):
    shape, dtype, fill, scale, base, route = CASES[case]
    x = logits(shape, dtype, fill, scale, seed=1)
    want = np.asarray(j_ref.entropy_head(jnp.asarray(x.float().numpy())))
    assert_close(kernel_model(x, SIZE[dtype], base, route)[0], want)


# the Pallas kernel's tiles must divide R and V: (R, V), br, bv, route
@pytest.mark.parametrize("shape,br,bv,route", [
    ((16, 2), 16, 2, None), ((16, 64), 16, 32, None),
    ((32, 512), 16, 128, None), ((64, 128), 16, 32, (32, 1)),
    ((8, 2048), 8, 512, (512, 1)), ((4, 4096), 4, 1024, (512, 2))])
def test_kernel_model_matches_pallas_interpret(shape, br, bv, route):
    x = logits(shape, seed=2)
    want = np.asarray(j_ops.entropy_head(jnp.asarray(x.numpy()),
                                         impl="interpret", br=br, bv=bv))
    assert_close(kernel_model(x, route=route)[0], want)


# chip_smoke.py's phase-2 shapes, and the element size each runs at
PHASE2 = [((16, 2), 4), ((64, 2), 4), ((256, 30522), 4), ((7, 1000), 4),
          ((256, 30522), 2), ((5, 1), 4), ((5, 3), 4), ((3, 30521), 4),
          ((1, 30522), 4), ((16, 30522), 4), ((4, 256000), 4),
          ((65536, 2), 4), ((64, 30522), 4), ((256, 30521), 2)]


@pytest.mark.parametrize("shape,size", PHASE2)
def test_plan_covers_every_column_of_every_row_once(shape, size):
    x = torch.zeros(shape)
    _, count = kernel_model(x, size)
    assert bool((count == 1).all())


@pytest.mark.parametrize("shape", sorted({s for s, _ in PHASE2}))
def test_plan_routes(shape):
    threads, blocks = eh.plan(*shape)
    if shape[1] <= eh.NARROW_V:
        assert (threads, blocks) == (1, 1)
        return
    assert 32 <= threads <= eh.THREADS and threads & (threads - 1) == 0
    assert 1 <= blocks <= eh.CLUSTER_MAX
    assert blocks == 1 or threads == eh.THREADS


def test_plan_at_the_named_cases():
    """The Oracle's batch: one thread a row; the vocab case: a block a
    row, 256 blocks; a serving head's few rows: clusters."""
    assert eh.plan(16, 2) == (1, 1)
    assert eh.plan(256, 30522) == (512, 1)
    assert eh.plan(16, 30522) == (512, 4)
    assert eh.plan(4, 256000) == (512, 8)
    assert eh.plan(65536, 100) == (32, 1)


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    for name in ("THREADS", "VECS", "CLUSTER_MAX"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(eh, name), name
    assert f"V <= {eh.NARROW_V}" in src


def test_work_at_the_path_and_vocab_cases():
    """(16, 2) float32: 128 bytes of logits and 64 of H, 128 operations;
    (256, 30,522) float32: 31,254,528 + 1,024 bytes, 31,254,528
    operations; in bfloat16 the logits are half the bytes."""
    assert eh.work(16, 2, torch.float32) == (128.0, 192.0)
    assert eh.work(256, 30522, torch.float32) == (31_254_528.0, 31_255_552.0)
    assert eh.work(256, 30522, torch.bfloat16) == (31_254_528.0,
                                                  15_628_288.0)
