"""The helpers of the port's nonlinear protocols against the JAX
package's, on RING32 and RING64: `compare.le` and `compare.max_` (even
and odd lengths), `ops.square`, `ops.stack`, `ops.concat` (operands at
different carried exponents) and `sharing.from_public` / `zeros_like`.
The same input shares and the same key seeds on both sides give
bitwise-equal output shares, the same carried exponent and
record-for-record ledgers (test_torch_nonlinear.py's `_pair`), and the
decoded values agree with numpy.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.mpc import compare as j_compare, ops as j_ops
from repro.mpc import sharing as j_sharing
from repro_torch.mpc import compare, ops, prng, sharing
from test_torch_nonlinear import RINGS, _assert_same, _pair, _x64


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("shape,axis", [((3, 8), -1), ((3, 7), -1),
                                        ((5, 4), 0), ((2, 3, 1), 1)])
def test_tournament_max(ring, shape, axis):
    jr, pr = RINGS[ring]
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32) * 3
    jout, pout = _pair(jr, pr, x,
                       lambda s, k: j_compare.max_(s, axis=axis, key=k),
                       lambda s, k: compare.max_(s, axis=axis, key=k))
    _assert_same(jout, pout)
    np.testing.assert_allclose(sharing.reveal(pout[0]).numpy(),
                               x.max(axis, keepdims=True), atol=2e-3)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_le(ring):
    jr, pr = RINGS[ring]
    x = np.random.default_rng(8).normal(size=(2, 6)).astype(np.float32)
    y = np.random.default_rng(9).normal(size=(2, 6)).astype(np.float32)
    with _x64(jr):
        jy = j_sharing.share(jax.random.key(5), jnp.asarray(y), jr)
        jy_sh = np.asarray(jy.sh)
    py = sharing.Share(torch.as_tensor(jy_sh), pr)
    jout, pout = _pair(jr, pr, x, lambda s, k: j_compare.le(s, jy, k),
                       lambda s, k: compare.le(s, py, k))
    _assert_same(jout, pout)
    assert pout[0].fb == 0
    np.testing.assert_array_equal(
        sharing.reconstruct(pout[0]).numpy(), (x - y < 0).astype(int))


def _scaled_pair(mod, s, k):
    """s and 3*s: the product carries 2f, so stack/concat align them."""
    return [s, mod.mul_public(s, 3.0, key=k)]


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("op,axis", [("square", None), ("stack", 0),
                                     ("stack", 2), ("concat", 0),
                                     ("concat", -1)])
def test_local_ops(ring, op, axis):
    jr, pr = RINGS[ring]
    x = np.random.default_rng(10).normal(size=(3, 4)).astype(np.float32)

    def run(mod, prng_mod):
        def fn(s, k):
            if op == "square":
                return mod.square(s, k)
            xs = _scaled_pair(mod, s, prng_mod.fold_in(k, 1))
            return getattr(mod, op)(xs, axis=axis,
                                    key=prng_mod.fold_in(k, 2))
        return fn

    jout, pout = _pair(jr, pr, x, run(j_ops, jax.random), run(ops, prng))
    _assert_same(jout, pout)
    got = sharing.reveal(pout[0]).numpy()
    if op == "square":
        want = x.astype(np.float64) ** 2
    else:
        parts = [x, 3 * x]
        want = np.stack(parts, axis) if op == "stack" \
            else np.concatenate(parts, axis)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("fb", [None, 3])
def test_from_public_and_zeros_like(ring, fb):
    jr, pr = RINGS[ring]
    v = np.random.default_rng(11).normal(size=(2, 5)).astype(np.float32)
    with _x64(jr):
        js = j_sharing.from_public(jnp.asarray(v), jr, fb=fb)
        jz = j_sharing.zeros_like(js)
        want = (np.asarray(js.sh), js.fb, np.asarray(jz.sh), jz.fb)
    ps = sharing.from_public(torch.as_tensor(v), pr, fb=fb)
    pz = sharing.zeros_like(ps)
    np.testing.assert_array_equal(want[0], ps.sh.numpy())
    np.testing.assert_array_equal(want[2], pz.sh.numpy())
    assert (ps.fb, pz.fb) == (want[1], want[3])
    assert ps.sh.dtype == pr.dtype and ps.proto == "2pc"
    np.testing.assert_allclose(sharing.reveal(ps).numpy(), v,
                               atol=2.0 ** -ps.fb)
