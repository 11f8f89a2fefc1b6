"""The port's threefry PRNG and ring encoding against jax.random, bitwise.

Every share mask of the MPC path is drawn from these functions, so the
port's shares can only equal the JAX package's if each key operation
does. RING64 draws go through JAX's `randint` under 64-bit mode; the
installed jax has no `jax.experimental.enable_x64`, so the tests alias
it to `jax.enable_x64` for their own scope (the JAX package is not
edited).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RING32, RING64


@pytest.fixture
def jax_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    with jax.enable_x64():
        yield


def kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 0x5e1ec7 ^ 1234])
def test_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(kd(jk), tk.numpy())
    for d in (0, 1, 100, 2 ** 32 - 1):
        np.testing.assert_array_equal(kd(jax.random.fold_in(jk, d)),
                                      prng.fold_in(tk, d).numpy())
    for n in (1, 2, 5, 17):
        np.testing.assert_array_equal(kd(jax.random.split(jk, n)),
                                      prng.split(tk, n).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_bits(shape):
    jk, tk = jax.random.key(11), prng.key(11)
    np.testing.assert_array_equal(
        u32(jax.random.bits(jk, shape, jnp.uint32)),
        prng.bits(tk, shape).numpy())


def test_batched_keys_direct_and_vmapped():
    """(n, 2) keys: the batched call and torch.func.vmap both equal
    jax.vmap over the JAX keys."""
    jks = jax.random.split(jax.random.key(3), 4)
    tks = prng.split(prng.key(3), 4)
    want = u32(jax.vmap(lambda k: jax.random.bits(k, (2, 3),
                                                  jnp.uint32))(jks))
    np.testing.assert_array_equal(want, prng.bits(tks, (2, 3)).numpy())
    np.testing.assert_array_equal(
        want, torch.func.vmap(lambda k: prng.bits(k, (2, 3)))(tks).numpy())
    np.testing.assert_array_equal(
        kd(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks)),
        torch.func.vmap(lambda k: prng.fold_in(k, 9))(tks).numpy())


@pytest.mark.parametrize("shape", [(5,), (4, 3), (2, 2, 9)])
def test_randint_full_uint32_range(shape, jax_x64):
    """randint(0, 2**32, uint32) is not bits(): JAX folds two draws."""
    jk, tk = jax.random.key(5), prng.key(5)
    want = u32(jax.random.randint(jk, shape, 0, 1 << 32, dtype=jnp.uint32))
    got = prng.randint_u32(tk, shape).numpy()
    np.testing.assert_array_equal(want, got)
    assert not np.array_equal(
        got, u32(jax.random.bits(jk, shape, jnp.uint32)))


def test_ring32_rand():
    np.testing.assert_array_equal(
        np.asarray(J_RING32.rand(jax.random.key(2), (6, 7))),
        RING32.rand(prng.key(2), (6, 7)).numpy())


def test_ring64_rand(jax_x64):
    np.testing.assert_array_equal(
        np.asarray(J_RING64.rand(jax.random.key(2), (6, 7))),
        RING64.rand(prng.key(2), (6, 7)).numpy())


@pytest.mark.parametrize("fb", [12, 16, 20, 24, -3])
def test_encode_decode_ring32(fb):
    x = np.random.default_rng(fb & 7).normal(size=(64,)).astype(np.float32)
    x[:4] = [0.5 / 2 ** 12, 1.5 / 2 ** 12, -2.5 / 2 ** 12, 0.0]  # ties
    enc = J_RING32.encode_at(jnp.asarray(x), fb)
    got = RING32.encode_at(torch.from_numpy(x), fb)
    np.testing.assert_array_equal(np.asarray(enc), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(J_RING32.decode_at(enc, fb)),
        RING32.decode_at(got, fb).numpy())
    for v in (1.0, 1e-5, 1 / 3, -8.0):
        assert RING32.encode_at(v, fb) == int(J_RING32.encode_at(
            jnp.asarray(v), fb))


def test_encode_decode_ring64(jax_x64):
    x = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    for fb in (16, 32, 48):
        enc = J_RING64.encode_at(jnp.asarray(x), fb)
        got = RING64.encode_at(torch.from_numpy(x), fb)
        np.testing.assert_array_equal(np.asarray(enc), got.numpy())
        np.testing.assert_array_equal(
            np.asarray(J_RING64.decode_at(enc, fb)),
            RING64.decode_at(got, fb).numpy())
        for v in (1.0, 1e-5, 1 / 3, -8.0):
            assert RING64.encode_at(v, fb) == int(J_RING64.encode_at(
                jnp.asarray(v), fb))


# ---------------------------------------------------------------------------
# bounded draws: randint (int32), uniform and normal (float32)
# ---------------------------------------------------------------------------

# `prng.normal` against `jax.random.normal`: the uniform draw is bitwise
# equal, and so is erf_inv's polynomial (its multiply-adds fused as XLA
# fuses them); only log1p rounds differently (XLA's CPU log1p is its own
# approximation). The bound held here, over 2 x 2**16 draws, with more
# than 98 % of them bitwise:
NORMAL_ULP = 3


def f32_ulp(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32)
                  .astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0, 2 ** 31 - 1),            # the bootstrap seed (selection_plan)
    ((8,), 0, 8),                    # finetune batch indices, a power of 2
    ((32,), 0, 13),                  # ... and not a power of 2
    ((3, 5), -5, 27),
    ((1000,), 0, 100003),
    ((9,), 3, 3),                    # empty span: always minval
    ((6,), 10, 2),                   # maxval < minval: always minval
    ((4,), -2 ** 31, 2 ** 31 - 1)])  # the widest int32 span
def test_randint_bounded(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo,
                                         hi)).astype(np.int64)
    got = prng.randint(prng.key(seed), shape, lo, hi).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape,lo,hi", [((1000,), 0.0, 1.0),
                                         ((10, 10), -3.0, 7.5),
                                         ((), 0.0, 1.0),
                                         ((64,), -0.99999994, 1.0)])
def test_uniform_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.key(seed), shape, lo, hi).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(f32_ulp(want, got), 0)


@pytest.mark.parametrize("seed", [1, 12345])
def test_normal_within_measured_ulp(seed):
    want = np.asarray(jax.random.normal(jax.random.key(seed), (1 << 16,)))
    got = prng.normal(prng.key(seed), (1 << 16,)).numpy()
    ulp = f32_ulp(want, got)
    assert ulp.max() <= NORMAL_ULP, ulp.max()
    assert (ulp == 0).mean() > 0.98


def test_erf_inv_polynomial_bitwise_given_jax_log1p(monkeypatch):
    """With XLA's own w = -log1p(-x^2) fed in, the rest of erf_inv is
    bitwise: the bound above is log1p's alone."""
    x = np.random.default_rng(0).uniform(-1, 1, 1 << 14).astype(np.float32)
    jw = np.asarray(jax.jit(lambda x: -jnp.log1p(-x * x))(x))
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    monkeypatch.setattr(torch, "log1p", lambda t: -torch.from_numpy(jw))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(f32_ulp(want, got), 0)
