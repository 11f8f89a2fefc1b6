"""The limb arithmetic of the secure_matmul kernel (csrc/secure_matmul.cu),
on the CPU, against the plain version `secure_matmul_plain` and the JAX
package's Pallas kernel.

The kernel computes each party's combine as one ring product over a K
twice as long, z_p = c_p + [eps | a_p] @ [b'_p ; dlt] with b'_0 = b_0 +
dlt (a wrapping add, before the byte split) and b'_1 = b_1. Both halves'
u8 limb products issue into the same diagonal D_s = sum_{i + j = s}
(eps_i b'_j + a_i dlt_j), summed exactly in s32 over at most K_CHUNK
elements of K, then folded onto c_p with wrapping. `combine_limbs` below
is that arithmetic in plain torch (numpy's wrapping unsigned integers for
the fold); it is a model for this test and runs on no path.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_kops
from repro_torch.kernels import build
from repro_torch.kernels import ring_matmul as rmm
from repro_torch.kernels import secure_matmul as smm

RINGS = [torch.int32, torch.int64]
U = {torch.int32: np.uint32, torch.int64: np.uint64}
BK = {torch.int32: 64, torch.int64: 32}     # elements of K a k-tile


def limbs(x: torch.Tensor) -> list[torch.Tensor]:
    """The L bytes of x's two's-complement bits, lowest first, as int64."""
    w = x.to(torch.int64)
    return [(w >> (8 * i)) & 0xFF for i in range(x.dtype.itemsize)]


def combine_limbs(eps, dlt, a_sh, b_sh, c_sh, k_chunk: int,
                  diag_max: list | None = None, add_limbs: bool = False):
    """Both parties' combine (2, *batch, M, N), the kernel's way: per chunk
    of K, each diagonal's products of both halves in one accumulator,
    which must stay in [0, 2**31) (s32, no wrap), then folded onto c_p
    with wrapping. `add_limbs` adds b_0 and dlt limb by limb, with no
    carry between limbs: the order the kernel must not take."""
    n_limbs, k = eps.dtype.itemsize, eps.shape[-1]
    u = U[eps.dtype]
    el, dl = limbs(eps), limbs(dlt)
    out = []
    for p in (0, 1):
        if p == 1:
            bl = limbs(b_sh[1])
        elif add_limbs:
            bl = [(x + y) & 0xFF for x, y in zip(limbs(b_sh[0]), dl)]
        else:
            bl = limbs(b_sh[0] + dlt)           # wraps in the ring
        al = limbs(a_sh[p])
        z = c_sh[p].numpy().view(u).copy()
        for k0 in range(0, k, k_chunk):
            ks = slice(k0, k0 + k_chunk)
            for s in range(n_limbs):
                d = sum(x[i][..., ks] @ y[s - i][..., ks, :]
                        for x, y in ((el, bl), (al, dl))
                        for i in range(s + 1))
                assert int(d.min()) >= 0 and int(d.max()) < 2 ** 31, s
                if diag_max is not None:
                    diag_max[s] = max(diag_max[s], int(d.max()))
                z += d.numpy().astype(u) << u(8 * s)
        out.append(torch.from_numpy(z.view(np.int32 if u is np.uint32
                                           else np.int64)))
    return torch.stack(out)


def rand_ring(rng, shape, dtype):
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                         dtype=np.int64, endpoint=True)
                            ).to(dtype)


def operands(rng, batch, m, k, n, dtype):
    b = (batch,) if batch else ()
    return [rand_ring(rng, s, dtype)
            for s in (b + (m, k), b + (k, n), (2,) + b + (m, k),
                      (2,) + b + (k, n), (2,) + b + (m, n))]


@pytest.mark.parametrize("dtype", RINGS)
@pytest.mark.parametrize("bmkn", [(3, 7, 45, 13), (2, 5, 1, 16),
                                  (1, 9, 16, 1), (4, 16, 64, 8),
                                  (0, 11, 70, 9)])
def test_limb_model_matches_plain_on_random_values(dtype, bmkn):
    rng = np.random.default_rng(sum(bmkn))
    args = operands(rng, *bmkn, dtype)
    got = combine_limbs(*args, smm.K_CHUNK[dtype])
    assert torch.equal(got, smm.secure_matmul_plain(*args))


@pytest.mark.parametrize("dtype", RINGS)
@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("fill", ["all -1", "all 0xFF bytes"])
def test_limb_model_matches_plain_on_worst_case_bytes(dtype, extra, fill):
    """Every operand -1, or also b_0 = 0 so that party 0's b_0 + dlt is -1
    too: every limb product 0xFF x 0xFF, the diagonals at their largest,
    over K = K_CHUNK (one fold) and K_CHUNK + 1 (a second one)."""
    k_chunk = smm.K_CHUNK[dtype]
    k = k_chunk + extra
    shapes = ((2, k), (k, 3), (2, 2, k), (2, k, 3), (2, 2, 3))
    args = [torch.full(s, -1, dtype=dtype) for s in shapes]
    if fill == "all 0xFF bytes":
        args[3][0] = 0
    peak = [0] * dtype.itemsize
    got = combine_limbs(*args, k_chunk, peak)
    assert torch.equal(got, smm.secure_matmul_plain(*args))
    # party 1 (and party 0 with b_0 = 0) sums 2 (s + 1) 255**2 over a
    # whole chunk: just under 2**31 at the top diagonal
    assert peak == [2 * (s + 1) * 255 ** 2 * k_chunk
                    for s in range(dtype.itemsize)]


@pytest.mark.parametrize("dtype", RINGS)
def test_add_before_the_split(dtype):
    """b_0 + dlt added limb by limb, without the carries between limbs,
    is wrong: the kernel adds in the ring and splits the sum."""
    rng = np.random.default_rng(5)
    args = operands(rng, 2, 6, 40, 7, dtype)
    want = smm.secure_matmul_plain(*args)
    assert torch.equal(combine_limbs(*args, smm.K_CHUNK[dtype]), want)
    wrong = combine_limbs(*args, smm.K_CHUNK[dtype], add_limbs=True)
    assert torch.equal(wrong[1], want[1])
    assert not torch.equal(wrong[0], want[0])


@pytest.mark.parametrize("mkn", [(16, 16, 16), (32, 48, 16)])
def test_limb_model_matches_jax_pallas_kernel(mkn):
    """int32 combine vs repro.kernels.ops.secure_matmul, the Pallas kernel
    body in interpret mode, at tileable shapes."""
    rng = np.random.default_rng(sum(mkn) + 1)
    args = operands(rng, 0, *mkn, torch.int32)
    want = np.asarray(j_kops.secure_matmul(
        *(jnp.asarray(t.numpy()) for t in args), impl="interpret", bm=16,
        bn=16, bk=16))
    got = combine_limbs(*args, smm.K_CHUNK[torch.int32])
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("dtype", RINGS)
def test_source_states_the_wrappers_k_chunk(dtype):
    src = (build.CSRC / "secure_matmul.cu").read_text()
    name = {torch.int32: "K_CHUNK_I32", torch.int64: "K_CHUNK_I64"}[dtype]
    k_chunk = int(re.search(rf"{name} = (\d+);", src).group(1))
    assert k_chunk == smm.K_CHUNK[dtype] == rmm.K_CHUNK[dtype] // 2
    # the largest chunk that ends on a k-tile and keeps both halves of the
    # top diagonal in s32
    top = 2 * dtype.itemsize * 255 ** 2
    assert k_chunk % BK[dtype] == 0
    assert top * k_chunk < 2 ** 31 <= top * (k_chunk + BK[dtype])


@pytest.mark.parametrize("dtype", RINGS)
def test_work_counts_the_limb_products(dtype):
    e = dtype.itemsize
    limb_ops, ring_ops, nbytes = smm.work(4, 2048, 768, 768, dtype)
    # four ring products of 2 m n k: each party's combine over 2 k
    assert ring_ops == 4 * 2 * 4 * 2048 * 768 * 768
    assert limb_ops == {torch.int32: 10, torch.int64: 36}[dtype] * ring_ops
    assert nbytes == (3 * 4 * 2048 * 768 + 3 * 4 * 768 * 768
                      + 4 * 4 * 2048 * 768) * e
    # the path's projection combine is bound by its operations
    assert limb_ops / 1979e12 > nbytes / 3.35e12
    # a broadcast weight (dlt, b_0, b_1) is read once
    assert smm.work(5, 130, 70, 33, dtype, broadcast_b=True)[2] == \
        (3 * 5 * 130 * 70 + 3 * 70 * 33 + 4 * 5 * 130 * 33) * e
