"""The port's additive 2PC share layer against the JAX package's, bitwise.

Same numpy inputs and the same keys on both sides: sharing, opening,
the Beaver multiply and matmul (both combine routes), the dealer and
local truncations and the comparison-bit ReLU must give bitwise equal
share components and record-for-record equal ledgers, on both rings.
RING64 runs the JAX side under a test-scoped 64-bit mode (the installed
jax has no `jax.experimental.enable_x64`; the tests alias it).
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.mpc import comm as j_comm, compare as j_compare, ops as j_ops
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro.mpc.sharing import open_ as j_open, share as j_share
from repro_torch.mpc import comm, compare, ops, prng
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.mpc.sharing import open_, share

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}


@pytest.fixture(params=sorted(RINGS))
def rings(request, monkeypatch):
    jr, tr = RINGS[request.param]
    if jr.bits == 64:
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
        ctx = jax.enable_x64()
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        yield jr, tr


def records(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


def both(jr, tr, x, seed):
    """The same float input shared on both sides under key `seed`."""
    js = j_share(jax.random.key(seed), jnp.asarray(x), jr)
    ts = share(prng.key(seed), torch.from_numpy(x), tr)
    np.testing.assert_array_equal(np.asarray(js.sh), ts.sh.numpy())
    return js, ts


def run(jfn, tfn):
    with j_comm.ledger_scope() as jl:
        jo = jfn()
    with comm.ledger_scope() as tl:
        to = tfn()
    np.testing.assert_array_equal(np.asarray(jo.sh), to.sh.numpy())
    assert jo.fb == to.fb
    assert records(jl) == records(tl)
    return jo, to


def test_share_open_roundtrip(rings):
    jr, tr = rings
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    js, ts = both(jr, tr, x, 1)
    with j_comm.ledger_scope() as jl:
        jv = j_open(js)
    with comm.ledger_scope() as tl:
        tv = open_(ts)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert records(jl) == records(tl)


def test_mul_and_trunc(rings):
    jr, tr = rings
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    (jx, tx), (jy, ty) = both(jr, tr, x, 2), both(jr, tr, y, 3)
    jz, tz = run(lambda: j_ops.mul(jx, jy, jax.random.key(4)),
                 lambda: ops.mul(tx, ty, prng.key(4)))
    run(lambda: j_ops.trunc(jz, key=jax.random.key(5)),
        lambda: ops.trunc(tz, key=prng.key(5)))
    run(lambda: j_ops.trunc(jz, key=None, shift=7),
        lambda: ops.trunc(tz, key=None, shift=7))


@pytest.mark.parametrize("shapes", [((6, 8), (8, 5)),
                                    ((2, 3, 6, 8), (2, 3, 8, 4))])
def test_matmul_both_combines(rings, shapes):
    """2-D products take the fused secure_matmul combine on RING32 (the
    JAX side its Pallas combine, in interpret mode); batched products
    and RING64 the three-ring_matmul combine."""
    jr, tr = rings
    rng = np.random.default_rng(6)
    x, y = (rng.normal(size=s).astype(np.float32) for s in shapes)
    (jx, tx), (jy, ty) = both(jr, tr, x, 7), both(jr, tr, y, 8)
    for fused, impl in ((False, None), (True, "interpret")):
        run(lambda: j_ops.matmul(jx, jy, jax.random.key(9),
                                 combine_impl=impl),
            lambda: ops.matmul(tx, ty, prng.key(9), fused_combine=fused))


def test_relu_and_public_ops(rings):
    jr, tr = rings
    x = np.random.default_rng(10).normal(size=(3, 9)).astype(np.float32)
    jx, tx = both(jr, tr, x, 11)
    run(lambda: j_compare.relu(jx, jax.random.key(12)),
        lambda: compare.relu(tx, prng.key(12)))
    run(lambda: j_ops.mul_public(j_ops.add_public(jx, 0.3), 0.37,
                                 key=jax.random.key(13)),
        lambda: ops.mul_public(ops.add_public(tx, 0.3), 0.37,
                               key=prng.key(13)))
    run(lambda: j_ops.mean(jx, axis=-1, key=jax.random.key(14)),
        lambda: ops.mean(tx, axis=-1, key=prng.key(14)))
