"""The port's ring kernels: plain versions against the JAX package's
secure_matmul (Pallas interpret mode and its jnp reference), bitwise;
and the custom ops' dispatch, vmap rules and meta (fake) impls. The
CUDA kernels themselves are held against their plain versions on the
card by test_torch_kernels_gpu.py and chip_smoke.py.

All ring arithmetic is exact, so every comparison here is bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as j_kops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels import ring_matmul as rmm
from repro_torch.kernels import secure_matmul as smm

def rand(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype,
                        endpoint=True)


def np_matmul(a, b):
    """Wrapping integer matmul in numpy (exact for int32 via int64
    products reduced mod 2**32; int64 wraps natively)."""
    if a.dtype == np.int32:
        return np.matmul(a.astype(np.int64), b.astype(np.int64)) \
            .astype(np.int32)
    return np.matmul(a, b)


def combine_inputs(rng, m, k, n, dtype, batch=()):
    return (rand(rng, batch + (m, k), dtype), rand(rng, batch + (k, n), dtype),
            rand(rng, (2,) + batch + (m, k), dtype),
            rand(rng, (2,) + batch + (k, n), dtype),
            rand(rng, (2,) + batch + (m, n), dtype))


# ---------------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("mkn", [(16, 16, 16), (24, 40, 8), (130, 7, 9)])
def test_plain_secure_matmul_matches_jax(impl, mkn):
    """int32 combine vs repro.kernels.ops.secure_matmul (the Pallas
    kernel body in interpret mode, padded where not tileable, and its
    jnp reference)."""
    rng = np.random.default_rng(sum(mkn))
    args = combine_inputs(rng, *mkn, np.int32)
    want = np.asarray(j_kops.secure_matmul(*map(jnp.asarray, args),
                                           impl=impl, bm=16, bn=16, bk=16))
    got = smm.secure_matmul_plain(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_secure_matmul_batched_matches_numpy(dtype):
    rng = np.random.default_rng(3)
    eps, dlt, a, b, c = combine_inputs(rng, 9, 5, 7, dtype, batch=(3,))
    want = np.stack([c[0] + np_matmul(eps, b[0]) + np_matmul(a[0], dlt)
                     + np_matmul(eps, dlt),
                     c[1] + np_matmul(eps, b[1]) + np_matmul(a[1], dlt)])
    got = smm.secure_matmul_plain(*map(torch.from_numpy,
                                       (eps, dlt, a, b, c)))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fn", ["matmul", "chunks"])
def test_plain_ring_matmul_wraps(dtype, fn, monkeypatch):
    """Both plain routes — torch's CPU integer matmul and the K-chunked
    elementwise sum the card uses — wrap exactly like numpy, with batch
    broadcasting."""
    rng = np.random.default_rng(4)
    a, b = rand(rng, (2, 3, 6, 33), dtype), rand(rng, (33, 5), dtype)
    f = ref.ring_matmul if fn == "matmul" else ref.matmul_by_chunks
    if fn == "chunks":
        monkeypatch.setattr(ref, "_CHUNK_BYTES", 6 * 5 * 6 * 7)
    got = f(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(np_matmul(a, b), got.numpy())


# ---------------------------------------------------------------------------
# the custom ops: dispatch, counters, vmap rules, meta
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    kops.reset_rmm_stats()
    kops.reset_smm_stats()
    a, b = rand(rng, (4, 6), np.int64), rand(rng, (6, 3), np.int64)
    got = kops.ring_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(np_matmul(a, b), got.numpy())
    args = combine_inputs(rng, 4, 6, 3, np.int32)
    kops.secure_matmul(*map(torch.from_numpy, args))
    assert kops.rmm_stats() == {"kernel": 0, "ref": 1}
    assert kops.smm_stats() == {"kernel": 0, "ref": 1, "padded": 0}


def test_kernel_entry_rejects_cpu_tensors():
    """The launch path never falls back: it takes CUDA tensors only."""
    a = torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        rmm.launch(a, a)
    with pytest.raises(ValueError):
        smm.launch(a, a, a.expand(2, 1, 2, 2), a.expand(2, 1, 2, 2),
                   a.expand(2, 1, 2, 2))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_ring_matmul_vmap_rule(dtype):
    """vmapped lanes fold into one batched call and equal the per-lane
    products, whichever operand carries the lanes."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-99, 99, (3, 2, 5, 4), generator=g).to(dtype)
    b = torch.randint(-99, 99, (3, 4, 6), generator=g).to(dtype)
    w = torch.randint(-99, 99, (4, 6), generator=g).to(dtype)
    both = torch.func.vmap(kops.ring_matmul)(a, b[:, None].expand(3, 2, 4, 6))
    lhs = torch.func.vmap(lambda x: kops.ring_matmul(x, w))(a)
    for i in range(3):
        assert torch.equal(both[i], torch.matmul(a[i], b[i]))
        assert torch.equal(lhs[i], torch.matmul(a[i], w))


def test_secure_matmul_vmap_rule():
    """Lanes on the share operands' dim 1 (after the party axis), some
    operands unbatched (a weight's shares)."""
    rng = np.random.default_rng(6)
    eps, dlt, a, b, c = (torch.from_numpy(t) for t in
                         combine_inputs(rng, 5, 4, 3, np.int32, batch=(3,)))
    a_l, c_l = a.movedim(1, 2), c.movedim(1, 2)     # lanes at dim 2
    out = torch.func.vmap(
        lambda e, aa, cc: kops.secure_matmul(e, dlt[0], aa, b[:, 0], cc),
        in_dims=(0, 2, 2), out_dims=1)(eps, a_l, c_l)
    for i in range(3):
        want = smm.secure_matmul_plain(eps[i], dlt[0], a[:, i], b[:, 0],
                                       c[:, i])
        assert torch.equal(out[:, i], want)


def test_meta_tensors_take_the_fake_impls():
    m = torch.device("meta")
    kops.reset_rmm_stats()
    kops.reset_smm_stats()
    c = kops.ring_matmul(torch.empty((2, 7, 3), dtype=torch.int64, device=m),
                         torch.empty((3, 5), dtype=torch.int64, device=m))
    assert c.is_meta and c.shape == (2, 7, 5)
    z = kops.secure_matmul(*(torch.empty(s, dtype=torch.int32, device=m)
                             for s in ((7, 3), (3, 5), (2, 7, 3), (2, 3, 5),
                                       (2, 7, 5))))
    assert z.is_meta and z.shape == (2, 7, 5)
    assert kops.rmm_stats()["ref"] == 0 and kops.smm_stats()["ref"] == 0
