"""The port's protocol backends against the JAX package's, bitwise: the
products and truncations (the sharing, public ops, registry and helpers
are test_torch_protocols.py, whose harness this file shares).

For every backend on both rings, the same numpy inputs and keys on both
sides: `mul` (also against a broadcast row) and its forced truncation,
`matmul` of a projection (2-D @ 2-D) and of a batched product with the
2pc combine flag passed, `trunc` with a key at two shifts and without
one (spdz2pc raises on both sides), the 3pc zero sharing, and the
`trunc_reshare` / `trunc2` records with their sub-rounds. Shares,
exponents, ledgers and wire payloads are held as in
test_torch_protocols.run.
"""
import jax
import numpy as np
import pytest

from repro.mpc import ops as j_ops
from repro.mpc import protocols as j_protocols
from repro_torch.kernels import ops as kops
from repro_torch.mpc import comm, ops, prng, protocols
from repro_torch.mpc.sharing import reveal
from test_torch_protocols import (both, normal, proto_params, rings,  # noqa: F401
                                  run)


# ---------------------------------------------------------------------------
# mul, matmul, truncation
# ---------------------------------------------------------------------------

@proto_params
def test_mul_and_force(proto, rings):
    jr, tr = rings
    x, y = normal(5, (4, 6)), normal(6, (4, 6))
    jx, tx = both(jr, tr, x, 7, proto)
    jy, ty = both(jr, tr, y, 8, proto)
    jz, tz, _ = run(proto, lambda: j_ops.mul(jx, jy, jax.random.key(9)),
                    lambda: ops.mul(tx, ty, prng.key(9)))
    assert tz.excess == tr.frac_bits
    _, tf, _ = run(proto, lambda: j_ops.force(jz, jax.random.key(10)),
                   lambda: ops.force(tz, prng.key(10)))
    assert tf.fb == tr.frac_bits
    # a broadcast operand (a row against the matrix)
    jb, tb = both(jr, tr, y[:1], 11, proto)
    run(proto, lambda: j_ops.mul(jx, jb, jax.random.key(12)),
        lambda: ops.mul(tx, tb, prng.key(12)))


@proto_params
def test_matmul(proto, rings):
    jr, tr = rings
    a, w = normal(13, (2, 5, 8)), normal(14, (2, 8, 3))
    ja, ta = both(jr, tr, a, 15, proto)
    jw, tw = both(jr, tr, w, 16, proto)
    before = kops.rmm_stats()["ref"]
    # a projection (2-D @ 2-D), then a batched product (the attention's,
    # batch dims equal); the port's flag for the 2pc RING32 combine (the
    # JAX package's combine_impl) is passed and, off 2pc, ignored
    for jl, jm, tl, tm, want in ((ja[0], jw[0], ta[0], tw[0], a[0] @ w[0]),
                                 (ja, jw, ta, tw, a @ w)):
        _, tz, _ = run(proto,
                       lambda: j_ops.matmul(jl, jm, jax.random.key(17)),
                       lambda: ops.matmul(tl, tm, prng.key(17),
                                          fused_combine=True))
        _, tf, _ = run(proto,
                       lambda: j_ops.force(j_ops.matmul(
                           jl, jm, jax.random.key(17)), jax.random.key(18)),
                       lambda: ops.force(ops.matmul(tl, tm, prng.key(17)),
                                         prng.key(18)))
        assert tf.shape == want.shape
        np.testing.assert_allclose(reveal(tf).numpy(), want,
                                   atol=32 / tr.scale)
    # every integer product ran through ring_matmul's wrapper (its plain
    # version, on CPU tensors)
    assert kops.rmm_stats()["ref"] > before


@proto_params
@pytest.mark.parametrize("shift", [None, 5])
def test_trunc_keyed_and_keyless(proto, shift, rings):
    jr, tr = rings
    x = normal(19, (3, 5), 4.0)
    jx, tx = both(jr, tr, x, 20, proto)
    _, tz, _ = run(proto,
                   lambda: j_ops.trunc(jx, key=jax.random.key(21),
                                       shift=shift),
                   lambda: ops.trunc(tx, key=prng.key(21), shift=shift))
    s = tr.frac_bits if shift is None else shift
    assert tz.fb == tr.frac_bits - s
    if proto == "spdz2pc":
        for fn, sh in ((j_ops.trunc, jx), (ops.trunc, tx)):
            with pytest.raises(ValueError, match="MAC-preserving"):
                fn(sh, key=None, shift=shift)
        return
    _, tk, led = run(proto, lambda: j_ops.trunc(jx, key=None, shift=shift),
                     lambda: ops.trunc(tx, key=None, shift=shift))
    assert led.records == []          # the keyless boundary path is local


def test_zero_share_and_reshare_records(rings):
    jr, tr = rings
    jb, tb = j_protocols.get("3pc"), protocols.get("3pc")
    z = tb._zero_share(prng.key(22), (4, 3), tr)
    np.testing.assert_array_equal(
        np.asarray(jb._zero_share(jax.random.key(22), (4, 3), jr)),
        z.numpy())
    assert not (z[0] + z[1] + z[2]).any()
    x = normal(23, (6,), 2.0)
    for proto, op, rounds, comps, rnds in (("3pc", "trunc_reshare", 0, 1,
                                            {0}),
                                           ("aby3trunc", "trunc2", 2, 6,
                                            {0, 1})):
        jx, tx = both(jr, tr, x, 24, proto)
        jp = j_ops.mul(jx, jx, jax.random.key(25))
        tp = ops.mul(tx, tx, prng.key(25))
        tape = comm.WireTape(3)
        _, _, led = run(proto, lambda: j_ops.force(jp, jax.random.key(26)),
                        lambda: ops.force(tp, prng.key(26)))
        with comm.ledger_scope(), comm.wire_tape_scope(tape):
            ops.trunc(tp, key=prng.key(26), shift=tp.excess)
        (rec,) = led.records
        assert (rec.op, rec.rounds, rec.tag) == (op, rounds, "bw")
        assert rec.nbytes == comps * tr.elem_bytes * 6
        assert {m.rnd for m in tape.flights[0].msgs} == rnds
