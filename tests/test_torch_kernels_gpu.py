"""The CUDA kernels against their plain torch versions on the card (`gpu`
marker; every test skips without a CUDA device): the ring kernels
bitwise; the float kernels (flash_attn, mlp_softmax_attn, entropy_head)
with the largest error bounded by tol * max(1, max |plain|), tol 1e-4
for the attention kernels and 1e-5 for entropy_head in float32, 1e-2 for
the attention kernels' bfloat16 outputs (one bf16 rounding of the same
float32 result), flash_attn with and without its causal window and
with its prefix, and bidir over a longer key sequence; the
scans (ssd, with its final state, and rg_lru) within 1e-5 in float32
(the JAX package's tolerance for the same kernels), ssd's bfloat16 y
within 1e-2; the backward kernels (flash_attn at every head dim and
mask, mlp_softmax_attn, ssd, rg_lru) against autograd of the plain
versions, at the same tolerances; the clear scoring paths and the token
server, card against CPU.

This file imports no JAX, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ring_matmul as rmm
from repro_torch.kernels import secure_matmul as smm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False    # exact float32 plain
    return torch.device("cuda")


def assert_close(got, want, tol):
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * max(1.0, float(want.double().abs().max())), err


def randn(g, shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device=g.device) * scale) \
        .to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shapes", [((3, 67, 45), (3, 45, 131)),
                                    ((2, 64, 64), (2, 64, 64)),
                                    ((1, 128, 1), (1, 1, 16)),
                                    ((4, 9, 16), (4, 16, 1))])
def test_ring_matmul_kernel_matches_plain(cuda, dtype, shapes):
    g = torch.Generator(device=cuda).manual_seed(1)
    lo, hi = (-2 ** 31, 2 ** 31) if dtype == torch.int32 else \
        (-2 ** 63, 2 ** 63 - 1)
    a, b = (torch.randint(lo, hi, s, generator=g, dtype=dtype, device=cuda)
            for s in shapes)
    got = rmm.launch(a, b)
    assert torch.equal(got, ref.matmul_by_chunks(a, b))
    got_bc = rmm.launch(a, b[:1].expand_as(b))
    assert torch.equal(got_bc, ref.matmul_by_chunks(a, b[:1].expand_as(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["all -1", "K above K_CHUNK",
                                  "M and N off the tile", "K = 1", "N = 1",
                                  "K not a multiple of 32",
                                  "stride-0 weight", "batched B",
                                  "extremes", "K = 0", "unaligned"])
def test_ring_matmul_hard_cases_match_plain(cuda, dtype, case):
    """The limb kernel's edges, bitwise: every limb 0xFF, a fold across
    K_CHUNK, ragged tiles, the path's K = 1 and N = 1, a broadcast weight,
    INT_MIN / INT_MAX / -1 / 0 / 1 operands, an empty K (C = 0), and
    operands whose rows are not 16-byte aligned (element copies)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    info = torch.iinfo(dtype)
    kc = rmm.K_CHUNK[dtype]
    bmkn = {"all -1": (2, 130, 96, 70),
            "K above K_CHUNK": (2, 67, kc + 70, 34),
            "M and N off the tile": (3, 67, 64, 131),
            "K = 1": (4, 200, 1, 16),
            "N = 1": (4, 200, 16, 1),
            "K not a multiple of 32": (3, 70, 45, 40),
            "stride-0 weight": (5, 130, 70, 33),
            "batched B": (6, 100, 96, 72),
            "extremes": (2, 128, 128, 64),
            "K = 0": (2, 70, 0, 40),
            "unaligned": (3, 70, 64, 40)}[case]
    batch, m, k, n = bmkn
    if case == "all -1":
        a = torch.full((batch, m, k), -1, dtype=dtype, device=cuda)
        b = torch.full((batch, k, n), -1, dtype=dtype, device=cuda)
    elif case == "extremes":
        pick = torch.tensor([info.min, info.max, -1, 0, 1], dtype=dtype,
                            device=cuda)
        a, b = (pick[torch.randint(0, 5, s, generator=g, device=cuda)]
                for s in ((batch, m, k), (batch, k, n)))
    else:
        a = torch.randint(info.min, info.max, (batch, m, k), generator=g,
                          dtype=dtype, device=cuda)
        b = torch.randint(info.min, info.max, (batch, k, n), generator=g,
                          dtype=dtype, device=cuda)
        if case == "stride-0 weight":
            b = b[:1].expand_as(b)
        if case == "unaligned":      # one element past a 16-byte boundary
            a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view_as(a)
            b = torch.cat([b.new_zeros(1), b.flatten()])[1:].view_as(b)
    want = ref.matmul_by_chunks(a, b) if k else a.new_zeros((batch, m, n))
    assert torch.equal(rmm.launch(a, b), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("bmkn", [(3, 67, 45, 131), (2, 64, 64, 64),
                                  (1, 200, 1, 16)])
def test_secure_matmul_kernel_matches_plain(cuda, dtype, bmkn):
    bt, m, k, n = bmkn
    g = torch.Generator(device=cuda).manual_seed(2)
    lo, hi = (-2 ** 31, 2 ** 31) if dtype == torch.int32 else \
        (-2 ** 63, 2 ** 63 - 1)
    args = [torch.randint(lo, hi, s, generator=g, dtype=dtype, device=cuda)
            for s in ((bt, m, k), (bt, k, n), (2, bt, m, k), (2, bt, k, n),
                      (2, bt, m, n))]
    assert torch.equal(smm.launch(*args), smm.secure_matmul_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["all -1, K = K_CHUNK", "K above K_CHUNK",
                                  "stride-0 weight", "unaligned", "K = 1",
                                  "N = 1", "K = 0", "N = 16", "K = 16",
                                  "odd M, N and K", "extremes"])
def test_secure_matmul_hard_cases_match_plain(cuda, dtype, case):
    """The limb combine's edges, bitwise: every limb 0xFF over a whole
    K_CHUNK (both halves at their largest diagonal sums), a fold across
    K_CHUNK, a weight broadcast by stride 0, operands one element off a
    16-byte boundary (element copies, single-element c loads), the
    path's K = 1, N = 16 and K = 16 combines, N = 1, an empty K (z = c),
    odd shapes and INT_MIN / INT_MAX / -1 / 0 / 1 operands."""
    g = torch.Generator(device=cuda).manual_seed(3)
    info = torch.iinfo(dtype)
    kc = smm.K_CHUNK[dtype]
    bt, m, k, n = {"all -1, K = K_CHUNK": (2, 67, kc, 33),
                   "K above K_CHUNK": (2, 67, kc + 70, 34),
                   "stride-0 weight": (5, 130, 70, 33),
                   "unaligned": (3, 70, 64, 40),
                   "K = 1": (4, 200, 1, 16),
                   "N = 1": (4, 200, 16, 1),
                   "K = 0": (2, 70, 0, 40),
                   "N = 16": (2, 300, 512, 16),
                   "K = 16": (2, 300, 16, 512),
                   "odd M, N and K": (3, 67, 45, 131),
                   "extremes": (2, 128, 128, 64)}[case]
    shapes = ((bt, m, k), (bt, k, n), (2, bt, m, k), (2, bt, k, n),
              (2, bt, m, n))
    if case == "all -1, K = K_CHUNK":
        args = [torch.full(s, -1, dtype=dtype, device=cuda) for s in shapes]
    elif case == "extremes":
        pick = torch.tensor([info.min, info.max, -1, 0, 1], dtype=dtype,
                            device=cuda)
        args = [pick[torch.randint(0, 5, s, generator=g, device=cuda)]
                for s in shapes]
    else:
        args = [torch.randint(info.min, info.max, s, generator=g,
                              dtype=dtype, device=cuda) for s in shapes]
    if case == "stride-0 weight":
        args[1] = args[1][:1].expand_as(args[1])
        args[3] = args[3][:, :1].expand_as(args[3])
    if case == "unaligned":          # one element past a 16-byte boundary
        args = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view_as(t)
                for t in args]
    want = smm.secure_matmul_plain(*args) if k else args[4].clone()
    assert torch.equal(smm.launch(*args), want)


@pytest.mark.gpu
@pytest.mark.parametrize("ring_name", ["ring32", "ring64"])
def test_phase_on_the_card_runs_the_kernels(cuda, ring_name):
    """A small sieve phase on CUDA launches the kernels, never takes a
    plain version, and scores bitwise like the same phase on the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.paper_targets import TINY_TARGET
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.core.proxy import ProxySpec, random_proxy
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32, RING64
    ring = {"ring32": RING32, "ring64": RING64}[ring_name]
    cfg = dataclasses.replace(TINY_TARGET, vocab_size=64, d_model=32,
                              n_heads=2, n_kv_heads=2, d_head=16)
    spec = ProxySpec(1, 2, 4)
    pool = np.random.default_rng(0).integers(0, 64, (24, 8))
    scores = {}
    for dev in ("cuda", "cpu"):
        pp = random_proxy(torch.Generator().manual_seed(0), cfg, spec, 8, 2,
                          device=dev)
        ex = WaveExecutor(ExecConfig(wave=2, batch=8, ring=ring, device=dev))
        scores[dev] = ex.score_phase(prng.key(7), pp, cfg, pool, spec).sh
        d = ex.reports[-1].device
        assert ex.reports[-1].agrees()
        if dev == "cuda":
            assert d.matmul_kernel > 0 and d.matmul_ref == 0
            assert d.combine_ref == 0
            assert (d.combine_kernel > 0) == (ring.bits == 32)
    assert torch.equal(scores["cuda"].cpu(), scores["cpu"])


FLOAT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SCAN_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(3, 67, 67, 16, 1), (2, 128, 128, 64, 1),
                                   (1, 64, 64, 128, 1), (6, 96, 96, 32, 3),
                                   (2, 40, 100, 64, 2),
                                   (20, 130, 130, 256, 10)])
def test_flash_attn_kernel_matches_plain(cuda, dtype, causal, shape):
    """(BH, Sq, Skv, Dh, group): ragged, every head dim (256 as in
    RecurrentGemma, group 10), grouped kv, and Sq != Skv (non-causal
    only)."""
    from repro_torch.kernels import flash_attn as fa
    bh, sq, skv, dh, group = shape
    if causal and sq != skv:
        skv = sq
    g = torch.Generator(device=cuda).manual_seed(3)
    q = randn(g, (bh, sq, dh), dtype)
    k, v = (randn(g, (bh // group, skv, dh), dtype) for _ in range(2))
    got = fa.launch(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert_close(got, ref.flash_attn(q, k, v, causal=causal), FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 200, 64, 1, 50), (2, 67, 16, 1, 1),
                                   (4, 300, 32, 2, 100),
                                   (2, 256, 128, 1, 64),
                                   (20, 130, 256, 10, 64),
                                   (6, 96, 32, 3, 500)])
def test_flash_attn_window_matches_plain(cuda, dtype, shape):
    """(BH, S, Dh, group, window): the causal window (the "local" mask),
    ragged, narrower than a key tile, tile-aligned, Dh 256 with group
    10, and wider than the sequence."""
    from repro_torch.kernels import flash_attn as fa
    bh, s, dh, group, window = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    q = randn(g, (bh, s, dh), dtype)
    k, v = (randn(g, (bh // group, s, dh), dtype) for _ in range(2))
    got = fa.launch(q, k, v, True, window)
    torch.cuda.synchronize()
    assert_close(got, ref.flash_attn(q, k, v, causal=True, window=window),
                 FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (dtype, BH, Sq, Skv, Dh, group, causal, window, input scale)
    # scores of ~30 (inputs x 3): one tf32 pass misses 1e-4, 3xTF32 not
    ("f32", 6, 256, 256, 64, 1, False, 0, 3.0),
    ("f32", 4, 200, 200, 256, 2, True, 0, 3.0),
    ("bf16", 6, 256, 256, 64, 1, False, 0, 3.0),
    ("bf16", 4, 200, 200, 256, 2, True, 0, 3.0),
    # Skv not a multiple of any key tile (16, 32, 64), and Sq = 1
    ("f32", 3, 1, 77, 64, 1, False, 0, 1.0),
    ("bf16", 3, 1, 77, 256, 3, False, 0, 1.0),
    ("f32", 2, 50, 77, 128, 2, False, 0, 1.0),
    ("bf16", 2, 50, 77, 32, 1, False, 0, 1.0),
    # a window narrower than one key tile at Dh 256
    ("f32", 20, 130, 130, 256, 10, True, 16, 1.0),
    ("bf16", 20, 130, 130, 256, 10, True, 16, 1.0)])
def test_flash_attn_hard_cases_match_plain(cuda, case):
    """Cases a cheaper kernel would fail: large scores (float32 held at
    1e-4, so single-pass tf32 products fail), ragged key lengths, a
    single query, and a window inside one key tile."""
    from repro_torch.kernels import flash_attn as fa
    name, bh, sq, skv, dh, group, causal, window, scale = case
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
    g = torch.Generator(device=cuda).manual_seed(6)
    q = randn(g, (bh, sq, dh), dtype, scale)
    k = randn(g, (bh // group, skv, dh), dtype, scale)
    v = randn(g, (bh // group, skv, dh), dtype)
    got = fa.launch(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert_close(got, ref.flash_attn(q, k, v, causal=causal, window=window),
                 FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (BH, S, Dh, group, prefix): none, one key, inside a tile, = S, past
    # S, past a key tile at a ragged S, PaliGemma's Dh 256 group 8
    (4, 100, 64, 2, 0), (4, 100, 64, 2, 1), (4, 100, 64, 2, 30),
    (3, 77, 32, 1, 77), (3, 77, 32, 1, 90), (2, 200, 128, 1, 130),
    (16, 300, 256, 8, 128)])
def test_flash_attn_prefix_matches_plain(cuda, dtype, shape):
    """The prefix mask (key j kept for query i when j <= i or j < P)
    against the plain version."""
    from repro_torch.kernels import flash_attn as fa
    bh, s, dh, group, prefix = shape
    g = torch.Generator(device=cuda).manual_seed(12)
    q = randn(g, (bh, s, dh), dtype)
    k, v = (randn(g, (bh // group, s, dh), dtype) for _ in range(2))
    got = fa.launch(q, k, v, True, 0, prefix)
    torch.cuda.synchronize()
    assert_close(got, ref.flash_attn(q, k, v, causal=True, prefix_len=prefix),
                 FLOAT_TOL[dtype])


@pytest.mark.gpu
def test_flash_attn_prefix_refusals(cuda):
    """A prefix with a window, or without causal attention, is refused
    before a launch; under grad the prefix takes its backward kernel,
    within FLOAT_TOL of autograd of the plain forward."""
    from repro_torch.kernels import flash_attn as fa
    q = torch.zeros((2, 64, 64), device=cuda)
    for causal, window in ((True, 16), (False, 0)):
        with pytest.raises(ValueError, match="prefix"):
            fa.launch(q, q, q, causal, window, 8)
    g = torch.Generator(device=cuda).manual_seed(13)
    qg, kg, vg = _leaves(g, [(2, 64, 64)] * 3, torch.float32, [1.0] * 3)
    do = randn(g, (2, 64, 64))
    fa.reset_bwd_stats()
    got = _grads(fa.flash_attn(qg, kg, vg, prefix_len=8), (qg, kg, vg), do)
    assert fa.bwd_stats() == {"kernel": 2, "ref": 0}
    want = _grads(ref.flash_attn(qg, kg, vg, prefix_len=8), (qg, kg, vg), do)
    for a, b in zip(got, want):
        assert_close(a, b, FLOAT_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_cross_attention_matches_plain(cuda, dtype):
    """Whisper's cross-attention: bidir, 64 decoder queries over 1,500
    encoder keys (not a key-tile multiple), Dh 64, 12 heads, batch 2."""
    from repro_torch.kernels import flash_attn as fa
    g = torch.Generator(device=cuda).manual_seed(13)
    q = randn(g, (24, 64, 64), dtype)
    k, v = (randn(g, (24, 1500, 64), dtype) for _ in range(2))
    got = fa.launch(q, k, v, False)
    torch.cuda.synchronize()
    assert_close(got, ref.flash_attn(q, k, v, causal=False),
                 FLOAT_TOL[dtype])


def eh_logits(g, r, v, fill="randn", dtype=torch.float32):
    """(R, V) logits: N(0, 9), N(0, 1e8) ("scale 1e4") or rows each of
    one value ("equal")."""
    if fill == "equal":
        return randn(g, (r, 1), dtype, 3.0).expand(r, v).contiguous()
    return randn(g, (r, v), dtype, 1e4 if fill == "scale 1e4" else 3.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rv", [
    (16, 2), (64, 2), (256, 30522), (7, 1000),
    # the split kernel's hard cases: V of 1 and 3 (no whole vector), a
    # ragged tail (an odd row stride, off 16 bytes in every dtype), one
    # row, clusters of 4 and 8 blocks a row, many narrow rows, logits of
    # scale 1e4 (one-hot rows, m and s / z cancel) and all-equal rows
    (5, 1), (5, 3), (3, 30521), (1, 30522), (16, 30522), (4, 256000),
    (65536, 2), (256, 30521), (64, 30522, "scale 1e4"),
    (16, 30522, "equal")])
def test_entropy_head_kernel_matches_plain(cuda, dtype, rv):
    from repro_torch.kernels import entropy_head as eh
    g = torch.Generator(device=cuda).manual_seed(4)
    x = eh_logits(g, *rv, dtype=dtype)
    got = eh.launch(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rv[0],)
    assert_close(got, ref.entropy_head(x), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rv", [(16, 2), (7, 1000), (256, 30522),
                                (16, 30522), (4, 256000), (65536, 2)])
def test_entropy_head_two_launches_are_bitwise_equal(cuda, rv):
    """The triples are merged in a fixed order across lanes, warps and a
    cluster's ranks, with no atomics: two launches give the same bits."""
    from repro_torch.kernels import entropy_head as eh
    g = torch.Generator(device=cuda).manual_seed(5)
    x = eh_logits(g, *rv)
    first = eh.launch(x)
    assert torch.equal(first, eh.launch(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entropy_head_strided_and_unaligned_logits(cuda, dtype):
    """A transposed-then-sliced (R, V) view, which the wrapper makes
    contiguous before it allocates H; and logits starting one element
    past a 16-byte boundary, which shifts every row's head."""
    from repro_torch.kernels import entropy_head as eh
    g = torch.Generator(device=cuda).manual_seed(6)
    x = randn(g, (30530, 64), dtype, 3.0).t()[:, 3:30525]
    assert x.shape == (64, 30522) and not x.is_contiguous()
    got = eh.launch(x)
    torch.cuda.synchronize()
    assert_close(got, ref.entropy_head(x), 1e-5)
    for r, v in ((64, 30522), (16, 30522), (7, 1000)):
        xo = torch.empty(r * v + 1, dtype=dtype, device=cuda)[1:].view(r, v)
        xo.copy_(randn(g, (r, v), dtype, 3.0))
        assert xo.data_ptr() % 16
        got = eh.launch(xo)
        torch.cuda.synchronize()
        assert_close(got, ref.entropy_head(xo), 1e-5)


def msa_operands(g, bh, sq, skv, dh, hid, group, dtype):
    q = randn(g, (bh, sq, dh), dtype)
    k, v = (randn(g, (bh // group, skv, dh), dtype) for _ in range(2))
    w = (randn(g, (skv, hid), scale=0.2), randn(g, (hid,), scale=0.1),
         randn(g, (hid, skv), scale=0.2), randn(g, (skv,), scale=0.01))
    return q, k, v, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (3, 67, 67, 16, 4, 1), (2, 128, 128, 64, 16, 1), (1, 64, 64, 128, 64, 1),
    (4, 32, 32, 32, 2, 2), (6, 100, 100, 64, 16, 3),
    # Sq 1024: two query tiles a block of a cluster of 8
    (2, 1024, 1024, 64, 16, 1),
    # Sq 1 and Sq 8: a cluster of one, its keys in several chunks
    (4, 1, 100, 64, 16, 1), (2, 1, 2000, 16, 4, 1), (4, 8, 8, 32, 3, 1),
    # Skv not a multiple of C x 64: ragged slices, an unaligned W1 span
    (3, 512, 450, 64, 5, 1), (2, 300, 70, 32, 7, 1),
    # hid 64; Dh 128 with its 32-row key chunks, double-buffered
    (2, 128, 128, 64, 64, 1), (2, 200, 200, 128, 64, 1),
    (2, 64, 600, 128, 16, 1), (2, 512, 512, 16, 16, 1)])
def test_mlp_softmax_attn_kernel_matches_plain(cuda, dtype, shape):
    """(BH, Sq, Skv, Dh, hid, group)."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, w = msa_operands(g, *shape, dtype)
    got = msa.launch(q, k, v, *w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert_close(got, ref.mlp_softmax_attn(q, k, v, *w), FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(48, 512, 512, 64, 16, 1),
                                   (2, 1024, 450, 64, 5, 1),
                                   (2, 1, 2000, 128, 64, 1)])
def test_mlp_softmax_attn_launches_are_bitwise_equal(cuda, shape):
    """A is summed across the cluster in rank order, with no atomics:
    two launches on the same inputs give the same bits."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, w = msa_operands(g, *shape, torch.float32)
    first = msa.launch(q, k, v, *w)
    second = msa.launch(q, k, v, *w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_softmax_attn_unaligned_operands(cuda, dtype):
    """q and k starting off a 16-byte boundary (views into a larger
    buffer) and w1 rows of 3 floats: the wrapper realigns q and k, the
    kernel copies w1's unaligned span in 4-byte pieces at its edges."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(7)
    bh, sq, skv, dh, hid = 3, 130, 130, 32, 3
    q, k, v, w = msa_operands(g, bh, sq, skv, dh, hid, 1, dtype)
    qo, ko = (torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
              .view(x.shape) for x in (q, k))
    qo.copy_(q)
    ko.copy_(k)
    w1 = torch.empty(skv * hid + 1, device=cuda)[1:].view(skv, hid)
    w1.copy_(w[0])
    assert qo.data_ptr() % 16 and ko.data_ptr() % 16 and w1.data_ptr() % 16
    got = msa.launch(qo, ko, v, w1, *w[1:])
    torch.cuda.synchronize()
    assert_close(got, ref.mlp_softmax_attn(q, k, v, *w), FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_softmax_attn_permuted_q(cuda, dtype):
    """A dense but permuted q (the transpose of an (Sq, BH, Dh) array):
    the kernel writes a contiguous (BH, Sq, Dh) output, which the wrapper
    returns in that layout."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(8)
    bh, sq, dh, hid = 12, 130, 64, 16
    _, k, v, w = msa_operands(g, bh, sq, sq, dh, hid, 1, dtype)
    q = randn(g, (sq, bh, dh), dtype).transpose(0, 1)
    assert not q.is_contiguous()
    got = msa.launch(q, k, v, *w)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert_close(got, ref.mlp_softmax_attn(q, k, v, *w), FLOAT_TOL[dtype])


@pytest.mark.gpu
def test_clear_attend_batch_of_one_matches_plain(cuda):
    """ClearEngine.attend on one row with 12 heads (the last batch of a
    pool of N rows where N % batch == 1): the head-folded q is then a
    permuted view, and the kernel's output matches the plain version."""
    from repro_torch.engine import VARIANTS, ClearEngine
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, wk, dh, hid = 1, 100, 12, 64, 16
    q, k, v = (randn(g, (b * s, wk * dh)) for _ in range(3))
    w1, b1, w2, b2 = (randn(g, (s, hid), scale=0.2),
                      randn(g, (hid,), scale=0.1),
                      randn(g, (hid, s), scale=0.2),
                      randn(g, (s,), scale=0.01))
    pp = {"mlp_sm": [{"w1": w1, "b1": b1, "w2": w2, "b2": b2}]}
    qT = q.reshape(b, s, wk, 1, dh).movedim(1, 3)            # b wk g s dh
    kT = k.reshape(b, s, wk, dh).movedim(2, 1).transpose(-1, -2) \
        .reshape(b, wk, 1, dh, s)                            # b wk g dh s
    assert not qT.reshape(b * wk, s, dh).is_contiguous()
    kops.reset_msa_stats()
    got = ClearEngine().attend(pp, 0, qT, kT, v, VARIANTS["full"])
    torch.cuda.synchronize()
    assert kops.msa_stats() == {"kernel": 1, "ref": 0}
    want = ref.mlp_softmax_attn(
        q.reshape(s, wk, dh).transpose(0, 1),
        k.reshape(s, wk, dh).transpose(0, 1),
        v.reshape(s, wk, dh).transpose(0, 1), w1, b1, w2, b2)
    assert got.shape == (b, wk, 1, s, dh)
    assert_close(got.reshape(wk, s, dh), want, FLOAT_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["full", "no-se"])
def test_clear_proxy_on_the_card_runs_the_kernels(cuda, variant):
    """A clear proxy forward on CUDA launches mlp_softmax_attn (and, for
    the exact entropy, entropy_head), never a plain version, and scores
    within 1e-4 of the same forward on the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.paper_targets import TINY_TARGET
    from repro_torch.core.proxy import ProxySpec, random_proxy
    from repro_torch.engine import VARIANTS, ClearEngine, proxy_entropy
    from repro_torch.kernels import ops as kops
    cfg = dataclasses.replace(TINY_TARGET, vocab_size=64, d_model=64,
                              n_heads=4, n_kv_heads=2, d_head=16)
    spec = ProxySpec(2, 4, 8)
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (4, 40)))
    out = {}
    for dev in ("cuda", "cpu"):
        pp = random_proxy(torch.Generator().manual_seed(0), cfg, spec, 40, 3,
                          device=dev)
        kops.reset_msa_stats()
        kops.reset_eh_stats()
        out[dev] = proxy_entropy(ClearEngine(), pp, cfg, tok.to(dev), spec,
                                 VARIANTS[variant]).cpu()
        if dev == "cuda":
            assert kops.msa_stats() == {"kernel": 2, "ref": 0}
            assert kops.eh_stats() == {
                "kernel": int(variant == "no-se"), "ref": 0}
    assert_close(out["cuda"], out["cpu"], 1e-4)


@pytest.mark.gpu
def test_target_on_the_card_runs_the_kernels(cuda):
    """The target's entropy on CUDA goes through flash_attn (once a layer)
    and entropy_head, and agrees with the CPU within 1e-4."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.paper_targets import TINY_TARGET
    from repro_torch.core import target, tree
    from repro_torch.kernels import ops as kops
    cfg = dataclasses.replace(TINY_TARGET, n_layers=2, vocab_size=256,
                              d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                              d_ff=128)
    params = target.init_classifier(torch.Generator(device=cuda)
                                    .manual_seed(0), cfg, 3, device=cuda)
    tok = np.random.default_rng(0).integers(0, 256, (5, 70))
    kops.reset_fa_stats()
    kops.reset_eh_stats()
    ent = target.prediction_entropy(params, cfg, tok)
    logits = target.classifier_logits(params, cfg, tok)
    assert kops.fa_stats() == {"kernel": 2 * cfg.n_layers, "ref": 0}
    assert kops.eh_stats() == {"kernel": 1, "ref": 0}
    cpu = tree.to_device(params, "cpu")
    assert_close(logits.cpu(), target.classifier_logits(cpu, cfg, tok), 1e-4)
    assert_close(ent.cpu(), target.prediction_entropy(cpu, cfg, tok), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 3, 8, 16, 16),
                                   (1, 128, 2, 16, 32, 32),
                                   (2, 100, 3, 64, 128, 128),
                                   (1, 300, 2, 64, 128, 128),
                                   (2, 256, 5, 64, 128, 128)])
@pytest.mark.parametrize("with_state0", [False, True])
def test_ssd_kernel_matches_plain(cuda, dtype, shape, with_state0):
    """(B, T, H, P, N, chunk): small chunks, one ragged chunk only, T not
    a multiple of the chunk, several whole chunks; y and the final state
    against the sequential oracle, and against the plain chunked scan
    where T is a multiple of the chunk."""
    from repro_torch.kernels import ssd as ssd_k
    bsz, t, h, p, n, chunk = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    x = randn(g, (bsz, t, h, p), dtype)
    a = -randn(g, (bsz, t, h), scale=0.5).abs()
    b, c = (randn(g, (bsz, t, n), dtype, 0.3) for _ in range(2))
    s0 = randn(g, (bsz, h, p, n), scale=0.5) if with_state0 else None
    y, state = ssd_k.launch(x, a, b, c, chunk, s0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and state.dtype == torch.float32
    want_y, want_s = ref.ssd(x, a, b, c, s0)
    assert_close(y, want_y, 1e-5 if dtype == torch.float32 else 1e-2)
    assert_close(state, want_s, 1e-5)
    if t % chunk == 0:
        assert_close(state, ref.ssd_chunked(x, a, b, c, chunk, s0)[1], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # ((B, T, H, P, N), chunk, log decays a, initial state scale)
    ((1, 256, 3, 64, 128), 128, "zero", 0.5),
    ((1, 192, 3, 64, 128), 128, "very negative", 0.5),
    ((1, 192, 3, 64, 128), 128, "rand", 100.0),
    ((1, 40, 3, 64, 128), 1, "rand", 0.5),
    ((2, 130, 3, 1, 128), 128, "rand", 0.5),
    ((2, 130, 3, 64, 1), 128, "rand", 0.5),
    ((3, 1, 3, 64, 128), 128, "rand", 0.5),
    ((2, 100, 3, 40, 96), 48, "rand", 0.5)])
def test_ssd_kernel_hard_cases_match_plain(cuda, dtype, case):
    """The hard cases of tests/test_torch_ssd_tiles.py: no decay, decays
    that underflow (a <= -50), a large initial state, chunk 1, P, N and T
    of 1, and widths whose rows are not whole 16-byte chunks."""
    from repro_torch.kernels import ssd as ssd_k
    (bsz, t, h, p, n), chunk, a_kind, s0_scale = case
    g = torch.Generator(device=cuda).manual_seed(8)
    x = randn(g, (bsz, t, h, p), dtype)
    a = {"rand": -randn(g, (bsz, t, h), scale=0.5).abs(),
         "zero": torch.zeros((bsz, t, h), device=cuda),
         "very negative": -50.0 - randn(g, (bsz, t, h)).abs()}[a_kind]
    b, c = (randn(g, (bsz, t, n), dtype, 0.3) for _ in range(2))
    s0 = randn(g, (bsz, h, p, n), scale=s0_scale)
    y, state = ssd_k.launch(x, a, b, c, chunk, s0)
    torch.cuda.synchronize()
    want_y, want_s = ref.ssd(x, a, b, c, s0)
    assert_close(y, want_y, 1e-5 if dtype == torch.float32 else 1e-2)
    assert_close(state, want_s, 1e-5)


def lru_inputs(g, shape, a_kind="sigmoid", b0_scale=1.0):
    """a and b of the recurrence: a = sigmoid(N(0, 1)), 0, 1, or in the
    model's gate range [0.9, 0.9999] (b = sqrt(1 - a^2) N(0, 1) there, as
    the model scales it); b_0 times b0_scale, an initial state folded in."""
    if a_kind == "gate":
        a = 0.9 + 0.0999 * torch.rand(shape, generator=g, device=g.device)
        b = torch.sqrt(1 - a * a) * randn(g, shape)
    else:
        a = {"sigmoid": lambda: torch.sigmoid(randn(g, shape)),
             "zero": lambda: torch.zeros(shape, device=g.device),
             "one": lambda: torch.ones(shape, device=g.device)}[a_kind]()
        b = randn(g, shape)
    b[:, 0] *= b0_scale
    return a, b


# (B, T, D), a, b_0 scale: the serving shapes, then the chunked scan's
# hard cases: T of 1 and past a tile (129), D of 1 and past a lane group
# (33), no decay, the model's gate range and a large folded initial state
LRU_CASES = [((2, 64, 16), "sigmoid", 1.0), ((1, 128, 32), "sigmoid", 1.0),
             ((3, 100, 2560), "sigmoid", 1.0),
             ((4, 512, 2560), "sigmoid", 1.0),
             ((3, 1, 300), "sigmoid", 1.0), ((2, 129, 64), "sigmoid", 1.0),
             ((2, 300, 1), "sigmoid", 1.0), ((2, 200, 33), "sigmoid", 1.0),
             ((2, 300, 64), "one", 1.0), ((2, 300, 64), "zero", 1.0),
             ((4, 512, 256), "gate", 1.0), ((2, 300, 96), "gate", 100.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,a_kind,b0_scale", LRU_CASES)
def test_rg_lru_kernel_matches_plain(cuda, shape, a_kind, b0_scale):
    from repro_torch.kernels import rg_lru as lru_k
    g = torch.Generator(device=cuda).manual_seed(7)
    a, b = lru_inputs(g, shape, a_kind, b0_scale)
    got = lru_k.launch(a, b)
    torch.cuda.synchronize()
    assert_close(got, ref.rg_lru(a, b), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 2560), (2, 129, 33)])
def test_rg_lru_two_launches_are_bitwise_equal(cuda, shape):
    """Every sum of the chunked scan has a fixed order (no atomics)."""
    from repro_torch.kernels import rg_lru as lru_k
    g = torch.Generator(device=cuda).manual_seed(9)
    a, b = lru_inputs(g, shape, "gate")
    first = lru_k.launch(a, b)
    assert torch.equal(first, lru_k.launch(a, b))


@pytest.mark.gpu
def test_rg_lru_permuted_operands(cuda):
    """Dense but permuted a and b ((T, B, D) storage viewed as (B, T, D)):
    h comes back in the operands' index order."""
    from repro_torch.kernels import rg_lru as lru_k
    g = torch.Generator(device=cuda).manual_seed(10)
    a, b = (x.transpose(0, 1) for x in lru_inputs(g, (300, 3, 40)))
    assert not a.is_contiguous()
    got = lru_k.launch(a, b)
    torch.cuda.synchronize()
    assert_close(got, ref.rg_lru(a, b), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_2_7b", "recurrentgemma_2b"])
def test_serving_on_the_card_runs_the_kernels(cuda, arch):
    """Prefill and two decode steps of a smoke config on CUDA (float32)
    launch ssd, or rg_lru and flash_attn, once a layer, never a plain
    version, and agree with the CPU within 1e-4 of max |CPU|."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(load_arch(arch, smoke=True), dtype="float32")
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 18))
    out = {}
    for dev, p in (("cuda", params), ("cpu", tree.to_device(params, "cpu"))):
        for reset in (kops.reset_ssd_stats, kops.reset_lru_stats,
                      kops.reset_fa_stats):
            reset()
        lg, cache = T.prefill(p, cfg, {"tokens": tok[:, :16]}, max_len=24)
        logits = [lg]
        for j in range(2):
            lg, cache = T.decode_step(p, cfg, cache,
                                      {"tokens": tok[:, 16 + j:17 + j]},
                                      16 + j)
            logits.append(lg)
        out[dev] = torch.stack(logits).cpu()
        if dev == "cuda":
            kinds = cfg._layer_kinds()
            assert kops.ssd_stats() == {"kernel": kinds.count("ssd"),
                                        "ref": 0}
            assert kops.lru_stats() == {"kernel": kinds.count("rec"),
                                        "ref": 0}
            assert kops.fa_stats() == {"kernel": kinds.count("attn"),
                                       "ref": 0}
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= 1e-4 * float(out["cpu"].abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "granite_moe_3b",
                                  "whisper_small", "paligemma_3b"])
def test_zoo_serving_on_the_card_runs_the_kernel(cuda, arch):
    """Prefill and two decode steps of a zoo smoke config on CUDA
    (float32): flash_attn once an attention layer (the encdec family's
    encoder, decoder and cross-attention each), prefix-masked for the
    vlm family, never a plain version, and agreement with the CPU within
    1e-4 of max |CPU|."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(load_arch(arch, smoke=True), dtype="float32")
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 16))}
    prefix = 0
    if cfg.family == "vlm":
        prefix = cfg.n_prefix_tokens
        batch["patches"] = rng.standard_normal(
            (3, prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (3, 40, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (3, 2))
    out = {}
    for dev, p in (("cuda", params), ("cpu", tree.to_device(params, "cpu"))):
        kops.reset_fa_stats()
        lg, cache = T.prefill(p, cfg, batch, max_len=prefix + 24)
        logits = [lg]
        for j in range(2):
            lg, cache = T.decode_step(p, cfg, cache,
                                      {"tokens": tok[:, j:j + 1]},
                                      prefix + 16 + j)
            logits.append(lg)
        out[dev] = torch.stack(logits).float().cpu()
        if dev == "cuda":
            n = cfg.n_layers * (2 if cfg.family == "encdec" else 1) \
                + cfg.n_enc_layers
            assert kops.fa_stats() == {"kernel": n, "ref": 0}
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= 1e-4 * float(out["cpu"].abs().max()), err


@pytest.mark.gpu
def test_local_window_on_the_card_runs_the_kernel(cuda):
    """RecurrentGemma's smoke forward at a sequence past its window (40 >
    16): every local-attention layer launches the windowed flash_attn,
    never a plain version, and the logits agree with the CPU within 1e-4
    of max |CPU|."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(load_arch("recurrentgemma_2b", smoke=True),
                              dtype="float32")
    assert cfg.window_size < 40
    params = T.init_params(torch.Generator(device=cuda).manual_seed(1), cfg,
                           cuda)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40))}
    kops.reset_fa_stats()
    got, _ = T.forward_logits(params, cfg, batch)
    assert kops.fa_stats() == {"kernel": cfg._layer_kinds().count("attn"),
                               "ref": 0}
    want, _ = T.forward_logits(tree.to_device(params, "cpu"), cfg, batch)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


# ---------------------------------------------------------------------------
# the backward kernels, against autograd of the plain versions on the card
# ---------------------------------------------------------------------------

def _grads(out, inputs, do):
    return torch.autograd.grad(out, inputs, do)


def _leaves(g, shapes, dtype, scales=None):
    scales = scales or [1.0] * len(shapes)
    return [randn(g, s, dtype, sc).requires_grad_()
            for s, sc in zip(shapes, scales)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (dtype, BH, S, Dh, group, causal, window[, input scale]): M_g's
    # finetune at BERT width (8 x 12 heads), ragged S, causal with and
    # without a window, grouped kv heads, every head dim, bf16
    (torch.float32, 96, 512, 64, 1, False, 0),
    (torch.float32, 6, 100, 64, 1, False, 0),
    (torch.float32, 6, 130, 32, 3, True, 0),
    (torch.float32, 4, 200, 16, 2, True, 50),
    (torch.float32, 2, 150, 128, 1, False, 0),
    (torch.bfloat16, 12, 512, 64, 1, False, 0),
    (torch.bfloat16, 6, 67, 128, 3, True, 20),
    # S off the tiles (the dq pass walks keys by 64, the dk/dv pass
    # queries by 32 in float32 and 64 in bf16; both halved at Dh 128)
    (torch.float32, 4, 1, 64, 1, False, 0),
    (torch.float32, 4, 63, 64, 1, True, 0),
    (torch.float32, 4, 65, 64, 1, False, 0),
    (torch.float32, 4, 300, 64, 1, True, 0),
    # Dh 16, 32 and 128 in both dtypes
    (torch.float32, 4, 90, 16, 1, True, 0),
    (torch.float32, 4, 90, 32, 1, False, 0),
    (torch.float32, 2, 300, 128, 1, True, 0),
    (torch.bfloat16, 4, 90, 16, 1, False, 0),
    (torch.bfloat16, 4, 90, 32, 1, True, 0),
    (torch.bfloat16, 2, 300, 128, 1, False, 0),
    # group 10 (RecurrentGemma's grouping)
    (torch.float32, 10, 512, 64, 10, True, 0),
    (torch.bfloat16, 10, 300, 64, 10, True, 70),
    # a window whose first key tile is partial (70 is no multiple of 32)
    (torch.float32, 4, 300, 64, 1, True, 70),
    # inputs x 3, scores of ~30: one tf32 pass misses 1e-4, 3xTF32 not
    (torch.float32, 4, 512, 64, 1, False, 0, 3.0),
    (torch.float32, 4, 300, 64, 2, True, 70, 3.0)])
def test_flash_attn_backward_matches_plain_autograd(cuda, case):
    from repro_torch.kernels import flash_attn as fa
    dtype, bh, s, dh, group, causal, window, *scale = case
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _leaves(g, [(bh, s, dh), (bh // group, s, dh),
                          (bh // group, s, dh)], dtype,
                      (scale or [1.0]) * 2 + [1.0])
    do = randn(g, (bh, s, dh), dtype)
    fa.reset_bwd_stats()
    got = _grads(fa.flash_attn(q, k, v, causal=causal, window=window),
                 (q, k, v), do)
    assert fa.bwd_stats() == {"kernel": 2, "ref": 0}   # dq, then dk/dv
    want = _grads(ref.flash_attn(q, k, v, causal=causal, window=window),
                  (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert_close(a, b, FLOAT_TOL[dtype])


@pytest.mark.gpu
def test_flash_attn_backward_bitwise_and_strided(cuda):
    """Two launches give the same bits (dk and dv sum a group in order, no
    atomics); a permuted q (a transposed view) and a sliced k take the
    allocate-after-contiguous path and still agree with the plain
    version."""
    from repro_torch.kernels import flash_attn as fa
    g = torch.Generator(device=cuda).manual_seed(12)
    qb = randn(g, (130, 8, 64)).requires_grad_()
    kb = randn(g, (4, 140, 64)).requires_grad_()
    v = randn(g, (4, 130, 64)).requires_grad_()
    q, k = qb.transpose(0, 1), kb[:, 5:135]
    do = randn(g, (8, 130, 64))
    first = _grads(fa.flash_attn(q, k, v, causal=True), (qb, kb, v), do)
    second = _grads(fa.flash_attn(q, k, v, causal=True), (qb, kb, v), do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = _grads(ref.flash_attn(q, k, v, causal=True), (qb, kb, v), do)
    for a, b in zip(first, want):
        assert_close(a, b, FLOAT_TOL[torch.float32])


@pytest.mark.gpu
def test_flash_attn_backward_refuses_what_it_lacks(cuda):
    """Only causal attention with Sq != Skv has no backward (the forward
    refuses it too): asking for it raises, never a plain gradient. Dh 256
    has its backward kernels now: three launches (dq, dk/dv per head, the
    group sum), a fourth where float32's dq pass walks its keys in parts
    (`bwd_splits`, `bwd_launches`), within FLOAT_TOL of autograd of the
    plain forward."""
    from repro_torch.kernels import flash_attn as fa
    q = torch.randn(2, 16, 64, device=cuda, requires_grad=True)
    k = torch.randn(2, 24, 64, device=cuda)
    with pytest.raises(ValueError, match="Sq 16 != Skv 24"):
        fa.flash_attn(q, k, k, causal=True)
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = _leaves(g, [(4, 70, 256), (2, 70, 256), (2, 70, 256)],
                      torch.float32, [1.0] * 3)
    do = randn(g, (4, 70, 256))
    fa.reset_bwd_stats()
    got = _grads(fa.flash_attn(q, k, v, causal=True), (q, k, v), do)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nsq = fa.bwd_splits(torch.float32, 4, 70, 70, sms)[0]
    assert fa.bwd_stats() == {"kernel": fa.bwd_launches(256, nsq), "ref": 0}
    want = _grads(ref.flash_attn(q, k, v, causal=True), (q, k, v), do)
    for a, b in zip(got, want):
        assert_close(a, b, FLOAT_TOL[torch.float32])
    with torch.no_grad():
        assert fa.flash_attn(q, q, q).shape == q.shape


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (dtype, BH, Sq, Skv, Dh, hid, group): in-vivo phase 2 <3,12,16> and
    # phase 1 <1,1,2> at batch 8, ragged S, a group, Skv != Sq, hid 64 at
    # Dh 128, bf16; then the head pass's other walks: two work items a
    # block (Sq 1024), a cluster of one (Sq 1), one key row (most blocks
    # own none), 17 kv heads (uneven head groups in the sum), a group of 4
    # with ragged tiles, and bf16 streaming its keys at Dh 128 and at Dh 16
    (torch.float32, 96, 512, 512, 64, 16, 1),
    (torch.float32, 8, 512, 512, 64, 2, 1),
    (torch.float32, 6, 100, 100, 64, 5, 1),
    (torch.float32, 6, 130, 130, 32, 7, 3),
    (torch.float32, 2, 64, 600, 128, 16, 1),
    (torch.float32, 2, 200, 200, 128, 64, 1),
    (torch.float32, 3, 70, 70, 16, 3, 1),
    (torch.bfloat16, 12, 512, 512, 64, 16, 1),
    (torch.float32, 4, 1024, 300, 64, 16, 1),
    (torch.float32, 3, 1, 9, 32, 4, 1),
    (torch.float32, 8, 300, 1, 64, 1, 1),
    (torch.float32, 17, 65, 65, 16, 2, 1),
    (torch.float32, 8, 100, 257, 32, 16, 4),
    (torch.bfloat16, 2, 64, 600, 128, 64, 1),
    (torch.bfloat16, 6, 90, 90, 16, 3, 3)])
def test_mlp_softmax_attn_backward_matches_plain_autograd(cuda, case):
    from repro_torch.kernels import mlp_softmax_attn as msa
    dtype, bh, sq, skv, dh, hid, group = case
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = _leaves(g, [(bh, sq, dh), (bh // group, skv, dh),
                          (bh // group, skv, dh)], dtype)
    w = _leaves(g, [(skv, hid), (hid,), (hid, skv), (skv,)], torch.float32,
                [0.2, 0.1, 0.2, 0.01])
    do = randn(g, (bh, sq, dh), dtype)
    msa.reset_bwd_stats()
    got = _grads(msa.mlp_softmax_attn(q, k, v, *w), (q, k, v, *w), do)
    # the head pass, then the head sum
    assert msa.bwd_stats() == {"kernel": 2, "ref": 0}
    want = _grads(ref.mlp_softmax_attn(q, k, v, *w), (q, k, v, *w), do)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert_close(a, b, FLOAT_TOL[dtype])


@pytest.mark.gpu
def test_mlp_softmax_attn_backward_bitwise_and_permuted(cuda):
    """Two launches give the same bits; a permuted q (the head-folded q of
    a batch of one row) agrees with the plain version."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(14)
    qb = randn(g, (512, 12, 64)).requires_grad_()
    q = qb.transpose(0, 1)
    k, v = _leaves(g, [(12, 512, 64), (12, 512, 64)], torch.float32)
    w = _leaves(g, [(512, 16), (16,), (16, 512), (512,)], torch.float32,
                [0.2, 0.1, 0.2, 0.01])
    do = randn(g, (12, 512, 64))
    ins = (qb, k, v, *w)
    first = _grads(msa.mlp_softmax_attn(q, k, v, *w), ins, do)
    second = _grads(msa.mlp_softmax_attn(q, k, v, *w), ins, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = _grads(ref.mlp_softmax_attn(q, k, v, *w), ins, do)
    for a, b in zip(first, want):
        assert_close(a, b, FLOAT_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_softmax_attn_backward_transposed_kv(cuda, dtype):
    """k and v as the strided views `engine.clear.mlp_attend` passes (k
    from kT transposed, v with its heads moved): the gradients agree with
    the plain version's, and two launches give the same bits."""
    from repro_torch.kernels import mlp_softmax_attn as msa
    g = torch.Generator(device=cuda).manual_seed(15)
    q = randn(g, (24, 512, 64), dtype).requires_grad_()
    kt = randn(g, (12, 64, 512), dtype).requires_grad_()
    vb = randn(g, (512, 12, 64), dtype).requires_grad_()
    k, v = kt.transpose(-1, -2), vb.transpose(0, 1)
    w = _leaves(g, [(512, 16), (16,), (16, 512), (512,)], torch.float32,
                [0.2, 0.1, 0.2, 0.01])
    do = randn(g, (24, 512, 64), dtype)
    ins = (q, kt, vb, *w)
    first = _grads(msa.mlp_softmax_attn(q, k, v, *w), ins, do)
    second = _grads(msa.mlp_softmax_attn(q, k, v, *w), ins, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = _grads(ref.mlp_softmax_attn(q, k, v, *w), ins, do)
    for a, b in zip(first, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert_close(a, b, FLOAT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["entropy_head", "ssd", "rg_lru"])
def test_fronts_without_backward_refuse_grad(cuda, kernel):
    """entropy_head has no backward: it raises on an input that requires
    grad in grad mode (its output would carry no gradient), and runs
    under no_grad. ssd and rg_lru have their backward kernels now: under
    grad each goes through its Function, launches its backward kernel
    (never a plain one) and agrees with autograd of its plain version
    within SCAN_TOL of max(1, max |plain|)."""
    from repro_torch.kernels import ops as kops
    x = torch.randn(2, 16, 3, 8, device=cuda)
    calls = {
        "entropy_head": (kops.entropy_head, (torch.randn(4, 30, device=cuda),)),
        "ssd": (kops.ssd_chunked, (x, -torch.rand(2, 16, 3, device=cuda),
                                   torch.randn(2, 16, 8, device=cuda),
                                   torch.randn(2, 16, 8, device=cuda))),
        "rg_lru": (kops.rg_lru_scan, (torch.rand(2, 16, 8, device=cuda),
                                      torch.randn(2, 16, 8, device=cuda)))}
    fn, args = calls[kernel]
    if kernel == "entropy_head":
        args = (args[0].clone().requires_grad_(),) + args[1:]
        with pytest.raises(RuntimeError,
                           match=f"{kernel} kernel has no backward"):
            fn(*args)
        with torch.no_grad():
            fn(*args)
        return
    args = tuple(a.clone().requires_grad_() for a in args)
    plain = {"ssd": lambda *a: ref.ssd(*a)[0], "rg_lru": ref.rg_lru}[kernel]
    stats = {"ssd": (kops.ssd_bwd_stats, kops.reset_ssd_bwd_stats),
             "rg_lru": (kops.lru_bwd_stats, kops.reset_lru_bwd_stats)}
    stats[kernel][1]()
    out = fn(*args)
    out = out[0] if kernel == "ssd" else out
    dy = torch.randn_like(out)
    got = _grads(out, args, dy)
    assert stats[kernel][0]()["ref"] == 0 and stats[kernel][0]()["kernel"]
    want = _grads(plain(*args), args, dy)
    for a, b in zip(got, want):
        assert_close(a, b, SCAN_TOL)
    with torch.no_grad():
        fn(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (dtype, BH, S, Dh, group, window, prefix): RecurrentGemma's local
    # layer (group 10, window past S) and PaliGemma's prefix (group 8),
    # cut in BH; bf16 Dh 256 at S off 64, a group of 3 that two key blocks
    # share unevenly, a window whose first tile is partial and a prefix
    # past a tile; prefixes of 1, = S and past a key tile; Dh 256 float32
    # with a window and bidir, at S off its 16-row tiles with a group of
    # 3, with a window whose first 16-key tile is partial, and split into
    # query-walk parts; the prefix at Dh 64 and 128
    (torch.bfloat16, 10, 512, 256, 10, 2048, 0),
    (torch.bfloat16, 8, 768, 256, 8, 0, 256),
    (torch.bfloat16, 6, 150, 256, 3, 0, 0),
    (torch.bfloat16, 4, 200, 256, 2, 70, 0),
    (torch.bfloat16, 4, 300, 256, 1, 0, 97),
    (torch.bfloat16, 2, 77, 256, 1, -1, 0),
    (torch.float32, 4, 130, 256, 2, 0, 1),
    (torch.float32, 4, 130, 256, 1, 0, 130),
    (torch.float32, 4, 130, 256, 2, 0, 97),
    (torch.float32, 4, 200, 256, 2, 70, 0),
    (torch.float32, 4, 150, 256, 1, -1, 0),
    (torch.float32, 6, 83, 256, 3, 0, 0),
    (torch.float32, 4, 90, 256, 2, 23, 0),
    (torch.float32, 8, 300, 256, 2, 0, 0),
    (torch.float32, 6, 300, 64, 3, 0, 100),
    (torch.bfloat16, 4, 300, 128, 1, 0, 65),
    (torch.float32, 4, 70, 64, 1, 0, 70)])
def test_flash_attn_backward_dh256_and_prefix_match_plain(cuda, case):
    """The backward at Dh 256 (on the tensor cores in both types: the dq
    pass, the dk and dv passes per q head, in float32 also per part of
    the query walk, the group sum) and with the prefix mask, against
    autograd of the plain version (window -1: bidirectional)."""
    from repro_torch.kernels import flash_attn as fa
    dtype, bh, s, dh, group, window, prefix = case
    causal, window = window >= 0, max(window, 0)
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = _leaves(g, [(bh, s, dh), (bh // group, s, dh),
                          (bh // group, s, dh)], dtype)
    do = randn(g, (bh, s, dh), dtype)
    fa.reset_bwd_stats()
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = _grads(fa.flash_attn(q, k, v, **kw), (q, k, v), do)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nsq = fa.bwd_splits(dtype, bh, s, s, sms)[0]
    assert fa.bwd_stats() == {"kernel": fa.bwd_launches(dh, nsq), "ref": 0}
    want = _grads(ref.flash_attn(q, k, v, **kw), (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert_close(a, b, FLOAT_TOL[dtype])
    again = _grads(fa.flash_attn(q, k, v, **kw), (q, k, v), do)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (dtype, B, T, H, P, N, decay, state0, dstate): Mamba-2's training
    # shape cut to 8 heads, in bf16 and float32; a chunk's worth and a
    # ragged T; no decay; decays that underflow; a large initial state
    # with its gradient; a final-state gradient; P and N off 32; T off the
    # chunk, heads off the chunk block's group (5 in bf16, 10 in float32),
    # P and N off the tiles (element loads); bf16 P past one state slice
    (torch.bfloat16, 2, 512, 8, 64, 128, "rand", False, False),
    (torch.bfloat16, 2, 150, 7, 64, 128, "rand", True, True),
    (torch.bfloat16, 1, 77, 3, 5, 7, "rand", True, True),
    (torch.bfloat16, 2, 100, 6, 40, 96, "underflow", False, True),
    (torch.bfloat16, 1, 64, 2, 16, 32, "none", True, False),
    (torch.float32, 2, 512, 8, 64, 128, "rand", False, False),
    (torch.float32, 1, 64, 3, 64, 128, "rand", False, False),
    (torch.float32, 2, 150, 3, 16, 32, "none", False, True),
    (torch.float32, 2, 150, 3, 16, 32, "underflow", True, False),
    (torch.float32, 2, 97, 4, 64, 128, "rand", True, True),
    (torch.float32, 1, 33, 2, 5, 7, "rand", True, True),
    (torch.float32, 2, 150, 13, 64, 128, "rand", True, True),
    (torch.float32, 2, 100, 6, 40, 96, "underflow", False, True),
    (torch.bfloat16, 1, 200, 4, 64, 128, "rand", True, True)])
def test_ssd_backward_matches_plain_autograd(cuda, case):
    from repro_torch.kernels import ssd as ssdk
    dtype, bsz, t, h, p, n, decay, s0, dst = case
    g = torch.Generator(device=cuda).manual_seed(16)
    x, b, c = _leaves(g, [(bsz, t, h, p), (bsz, t, n), (bsz, t, n)], dtype)
    u = torch.rand((bsz, t, h), generator=g, device=cuda)
    a = {"rand": -0.3 * u, "none": 0 * u, "underflow": -50 - u}[decay]
    a.requires_grad_()
    st0 = (randn(g, (bsz, h, p, n)) * 100).requires_grad_() if s0 else None
    ins = [v for v in (x, a, b, c, st0) if v is not None]
    dy, ds = randn(g, (bsz, t, h, p), dtype), randn(g, (bsz, h, p, n))

    def loss(y, s):
        return (y.float() * dy.float()).sum() + ((s * ds).sum() if dst
                                                  else 0)
    ssdk.reset_bwd_stats()
    got = torch.autograd.grad(loss(*ssdk.ssd_chunked(x, a, b, c,
                                                      state0=st0)), ins)
    assert ssdk.bwd_stats() == {"kernel": ssdk.bwd_launches(dtype),
                                "ref": 0}
    want = torch.autograd.grad(loss(*ref.ssd(x, a, b, c, state0=st0)), ins)
    tol = SCAN_TOL if dtype == torch.float32 else FLOAT_TOL[dtype]
    for gg, w in zip(got, want):
        assert gg.shape == w.shape
        assert_close(gg.float(), w.float(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, T, D, fill): RecurrentGemma's training width; T 1 and 129, D 1
    # and 33; a = 0; a = 1; the model's gate range
    (2, 512, 2560, "rand"), (2, 1, 64, "rand"), (2, 129, 33, "rand"),
    (3, 40, 1, "rand"), (2, 77, 40, "zero"), (2, 77, 40, "one"),
    (2, 300, 70, "gate")])
def test_rg_lru_backward_matches_plain_autograd(cuda, case):
    from repro_torch.kernels import rg_lru as lru
    bsz, t, d, fill = case
    g = torch.Generator(device=cuda).manual_seed(17)
    u = torch.rand((bsz, t, d), generator=g, device=cuda)
    a = {"rand": u, "zero": 0 * u, "one": 1 + 0 * u,
         "gate": torch.exp(-8 * 0.7 * u)}[fill].requires_grad_()
    b = randn(g, (bsz, t, d)).requires_grad_()
    dh = randn(g, (bsz, t, d))
    lru.reset_bwd_stats()
    got = _grads(lru.rg_lru_scan(a, b), (a, b), dh)
    assert lru.bwd_stats() == {"kernel": 1, "ref": 0}
    want = _grads(ref.rg_lru(a, b), (a, b), dh)
    for gg, w in zip(got, want):
        assert_close(gg, w, SCAN_TOL)


@pytest.mark.gpu
def test_rg_lru_backward_bitwise_and_permuted(cuda):
    """Permuted operands take the contiguous copies; two launches agree
    bitwise; the plain backward is bitwise the kernel's (the same
    roundings in the same order)."""
    from repro_torch.kernels import rg_lru as lru
    g = torch.Generator(device=cuda).manual_seed(18)
    a = torch.rand((300, 3, 70), generator=g, device=cuda).transpose(0, 1)
    h = randn(g, (70, 300, 3)).permute(2, 1, 0)
    dh = randn(g, (3, 300, 70))
    first, second = lru.launch_bwd(a, h, dh), lru.launch_bwd(a, h, dh)
    want = ref.rg_lru_bwd(a, h, dh)
    for x, y, z in zip(first, second, want):
        assert torch.equal(x, y) and torch.equal(x, z)
