"""The limb arithmetic of the ring_matmul kernel (csrc/ring_matmul.cu), on
the CPU, against the plain version `ref.ring_matmul`.

The kernel reads each ring element as its L little-endian bytes (limbs),
sums the u8 products of each diagonal D_s = sum_{i + j = s} A_i @ B_j
exactly in s32 over at most K_CHUNK elements of K, and folds C = sum_s
D_s << 8 s into the ring. `limb_matmul` below is that arithmetic in plain
torch (numpy's wrapping unsigned integers for the fold); it is a model
for this test and runs on no path. The byte split itself is the
`transpose4` of csrc/ring_limbs.cuh, whose `__byte_perm` selectors are
read from the header and run here.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import ring_matmul as rmm

RINGS = [torch.int32, torch.int64]
U = {torch.int32: np.uint32, torch.int64: np.uint64}


def limbs(x: torch.Tensor) -> list[torch.Tensor]:
    """The L bytes of x's two's-complement bits, lowest first, as int64."""
    w = x.to(torch.int64)
    return [(w >> (8 * i)) & 0xFF for i in range(x.dtype.itemsize)]


def limb_matmul(a: torch.Tensor, b: torch.Tensor, k_chunk: int,
                diag_max: list | None = None) -> torch.Tensor:
    """a @ b over the ring of a's dtype, the kernel's way: per chunk of K,
    each diagonal's u8 products summed in one accumulator, which must stay
    in [0, 2**31) (s32, no wrap), then folded into C with wrapping."""
    al, bl = limbs(a), limbs(b)
    n_limbs, k = len(al), a.shape[-1]
    u = U[a.dtype]
    c = np.zeros(a.shape[:-1] + b.shape[-1:], dtype=u)
    for k0 in range(0, k, k_chunk):
        ks = slice(k0, k0 + k_chunk)
        for s in range(n_limbs):
            d = sum(al[i][..., ks] @ bl[s - i][..., ks, :]
                    for i in range(s + 1))
            assert int(d.min()) >= 0 and int(d.max()) < 2 ** 31, s
            if diag_max is not None:
                diag_max[s] = max(diag_max[s], int(d.max()))
            c += d.numpy().astype(u) << u(8 * s)
    return torch.from_numpy(c.view(np.int32 if u is np.uint32 else np.int64))


def rand_ring(rng, shape, dtype):
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                         dtype=np.int64, endpoint=True)
                            ).to(dtype)


@pytest.mark.parametrize("dtype", RINGS)
@pytest.mark.parametrize("shapes", [((3, 7, 45), (3, 45, 13)),
                                    ((2, 5, 1), (2, 1, 16)),
                                    ((1, 9, 16), (1, 16, 1)),
                                    ((4, 16, 64), (4, 64, 8))])
def test_limb_model_matches_plain_on_random_values(dtype, shapes):
    rng = np.random.default_rng(7)
    a, b = (rand_ring(rng, s, dtype) for s in shapes)
    got = limb_matmul(a, b, rmm.K_CHUNK[dtype])
    assert torch.equal(got, ref.ring_matmul(a, b))


@pytest.mark.parametrize("dtype", RINGS)
@pytest.mark.parametrize("fill", ["all -1", "INT_MIN", "INT_MAX",
                                  "min x max", "mixed extremes"])
def test_limb_model_matches_plain_on_worst_case_bytes(dtype, fill):
    info = torch.iinfo(dtype)
    shape_a, shape_b = (2, 5, 70), (2, 70, 6)
    if fill == "all -1":                    # every limb 0xFF
        a, b = torch.full(shape_a, -1, dtype=dtype), \
            torch.full(shape_b, -1, dtype=dtype)
    elif fill in ("INT_MIN", "INT_MAX"):
        v = info.min if fill == "INT_MIN" else info.max
        a, b = torch.full(shape_a, v, dtype=dtype), \
            torch.full(shape_b, v, dtype=dtype)
    elif fill == "min x max":
        a, b = torch.full(shape_a, info.min, dtype=dtype), \
            torch.full(shape_b, info.max, dtype=dtype)
    else:
        rng = np.random.default_rng(3)
        pick = torch.tensor([info.min, info.max, -1, 0, 1], dtype=dtype)
        a, b = (pick[torch.from_numpy(rng.integers(0, 5, s))]
                for s in (shape_a, shape_b))
    got = limb_matmul(a, b, rmm.K_CHUNK[dtype])
    assert torch.equal(got, ref.ring_matmul(a, b))


@pytest.mark.parametrize("dtype", RINGS)
def test_k_chunk_keeps_every_diagonal_in_s32(dtype):
    k_chunk, n_limbs = rmm.K_CHUNK[dtype], dtype.itemsize
    for s in range(n_limbs):
        assert (s + 1) * 255 ** 2 * k_chunk < 2 ** 31, s
    # the kernel folds at the end of a k-tile of 256 bytes of A's row
    assert k_chunk % (256 // n_limbs) == 0
    # all-0xFF limbs over a whole chunk reach the bound: the top diagonal
    # sums L * 255**2 * K_CHUNK, just under 2**31
    a = torch.full((1, 1, k_chunk), -1, dtype=dtype)
    b = torch.full((1, k_chunk, 1), -1, dtype=dtype)
    peak = [0] * n_limbs
    assert torch.equal(limb_matmul(a, b, k_chunk, peak),
                       ref.ring_matmul(a, b))
    assert peak == [(s + 1) * 255 ** 2 * k_chunk for s in range(n_limbs)]


@pytest.mark.parametrize("dtype", RINGS)
def test_limb_model_folds_across_chunks(dtype):
    k_chunk = rmm.K_CHUNK[dtype]
    a = torch.full((1, 3, k_chunk + 37), -1, dtype=dtype)
    b = torch.full((1, k_chunk + 37, 2), -1, dtype=dtype)
    a[0, 1] = torch.iinfo(dtype).min
    got = limb_matmul(a, b, k_chunk)
    assert torch.equal(got, ref.ring_matmul(a, b))


def test_source_states_the_wrappers_k_chunk():
    src = (build.CSRC / "ring_matmul.cu").read_text()
    stated = {torch.int32: r"K_CHUNK_I32 = (\d+);",
              torch.int64: r"K_CHUNK_I64 = (\d+);"}
    for dtype, pat in stated.items():
        assert int(re.search(pat, src).group(1)) == rmm.K_CHUNK[dtype]


def _byte_perm(x: int, y: int, sel: int) -> int:
    """prmt's default mode: byte k of the result is byte (sel >> 4 k) & 7
    of the eight bytes x (0-3) then y (4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))


def test_transpose4_selectors_gather_each_limb():
    body = (build.CSRC / "ring_limbs.cuh").read_text()
    body = body[body.index("void transpose4"):]
    body = body[:body.index("\n}")]
    steps = re.findall(r"(t\d|out\[\d\]) = __byte_perm\((\w+), (\w+), "
                       r"(0x[0-9a-fA-F]+)\)", body)
    assert len(steps) == 8
    rng = np.random.default_rng(11)
    for _ in range(50):
        w = [int(v) for v in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
        env = {f"w{i}": w[i] for i in range(4)}
        for dst, x, y, sel in steps:
            env[dst] = _byte_perm(env[x], env[y], int(sel, 16))
        for limb in range(4):
            want = sum(((w[m] >> (8 * limb)) & 0xFF) << (8 * m)
                       for m in range(4))
            assert env[f"out[{limb}]"] == want


@pytest.mark.parametrize("dtype", RINGS)
def test_work_counts_the_limb_products(dtype):
    assert rmm.limb_pairs(dtype) == {torch.int32: 10, torch.int64: 36}[dtype]
    e = dtype.itemsize
    limb_ops, ring_ops, nbytes = rmm.work(384, 512, 64, 512, dtype)
    assert ring_ops == 2 * 384 * 512 * 512 * 64
    assert limb_ops == rmm.limb_pairs(dtype) * ring_ops
    assert nbytes == (2 * 384 * 512 * 64 + 384 * 512 * 512) * e
    # a broadcast weight is read once
    assert rmm.work(5, 130, 70, 33, dtype, broadcast_b=True)[2] == \
        (5 * 130 * 70 + 70 * 33 + 5 * 130 * 33) * e
