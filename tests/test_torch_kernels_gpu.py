"""The CUDA ring kernels against their plain torch versions, bitwise, on
the card (`gpu` marker; every test skips without a CUDA device).

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
    return torch.device("cuda")


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
