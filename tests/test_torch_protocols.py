"""The port's protocol backends (replicated3pc, aby3trunc, spdz2pc, beside
additive2pc) against the JAX package's, bitwise.

Same numpy inputs and the same keys on both sides, for every backend on
both rings: the registry, the MAC key, sharing, opening, the public ops,
and the helpers `triple_bytes`, `ops.mul_public_int` and
`ops.matmul_public` (the products and truncations are
test_torch_protocols_arith.py, on this file's harness). Every case holds the share components bitwise, the
carried exponent, the ledger record for record, and the wire payloads
message for message (a `comm.WireTape` on both sides, sized by the
backend's wire party count: src, dst, bytes and sub-round of each
message). RING64 runs the JAX side under a test-scoped 64-bit mode (the
installed jax has no `jax.experimental.enable_x64`; the tests alias it).
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.mpc import beaver as j_beaver, comm as j_comm, ops as j_ops
from repro.mpc import protocols as j_protocols
from repro.mpc.protocols import spdz2pc as j_spdz
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro.mpc.sharing import (from_public as j_from_public,
                               open_ as j_open, share as j_share)
from repro_torch.kernels import ops as kops
from repro_torch.mpc import beaver, comm, ops, prng, protocols
from repro_torch.mpc.protocols import spdz2pc
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.mpc.sharing import from_public, open_, reveal, share

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
PROTOS = ("2pc", "3pc", "spdz2pc", "aby3trunc")


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


proto_params = pytest.mark.parametrize("proto", PROTOS)


def records(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


def flights(tape):
    return [(f.op, f.rounds, f.nbytes, f.tag,
             [(m.src, m.dst, m.data, m.rnd) for m in f.msgs])
            for f in tape.flights]


def both(jr, tr, x, seed, proto):
    """The same float input shared on both sides under key `seed`."""
    js = j_share(jax.random.key(seed), jnp.asarray(x), jr, proto)
    ts = share(prng.key(seed), torch.from_numpy(np.asarray(x)), tr, proto)
    np.testing.assert_array_equal(np.asarray(js.sh), ts.sh.numpy())
    return js, ts


def run(proto, jfn, tfn):
    """Run both sides under a ledger and a wire tape; hold the outputs
    (shares or opened values) bitwise, the ledgers record for record and
    the tapes message for message."""
    n = protocols.get(proto).n_wire_parties
    assert j_protocols.get(proto).n_wire_parties == n
    jt, tt = j_comm.WireTape(n), comm.WireTape(n)
    with j_comm.ledger_scope() as jl, j_comm.wire_tape_scope(jt):
        jo = jfn()
    with comm.ledger_scope() as tl, comm.wire_tape_scope(tt):
        to = tfn()
    if hasattr(to, "sh"):
        np.testing.assert_array_equal(np.asarray(jo.sh), to.sh.numpy())
        assert (jo.fb, jo.proto) == (to.fb, to.proto)
    else:
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert records(jl) == records(tl)
    assert flights(jt) == flights(tt)
    return jo, to, tl


def normal(seed, shape, s=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * s).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_equals_jax():
    assert list(protocols.PROTOCOLS) == list(j_protocols.PROTOCOLS)
    assert protocols.__all__ == j_protocols.__all__
    for name, jb in j_protocols.PROTOCOLS.items():
        b = protocols.get(name)
        assert b.name == name == jb.name
        assert (b.n_parties, b.n_wire_parties, b.exact_trunc) == \
            (jb.n_parties, jb.n_wire_parties, jb.exact_trunc)
        assert hasattr(b, "mac_check_flight") == \
            hasattr(jb, "mac_check_flight")
        assert type(b).__name__ == type(jb).__name__
    with pytest.raises(ValueError, match="unknown protocol"):
        protocols.get("4pc")
    assert not hasattr(protocols, "NOT_PORTED")


def test_mac_key_equals_jax(rings):
    jr, tr = rings
    for j, t in zip(j_spdz.mac_key(jr), spdz2pc.mac_key(tr)):
        assert int(np.asarray(j)) == int(t)
    alpha, a0, a1 = spdz2pc.mac_key(tr, "meta")
    assert alpha.is_meta and alpha.shape == () and alpha.dtype == tr.dtype


# ---------------------------------------------------------------------------
# sharing, opening, public ops
# ---------------------------------------------------------------------------

@proto_params
def test_share_and_open(proto, rings):
    jr, tr = rings
    x = normal(0, (5, 7), 3.0)
    js, ts = both(jr, tr, x, 1, proto)
    assert ts.n_parties == protocols.get(proto).n_parties
    run(proto, lambda: j_open(js), lambda: open_(ts))
    np.testing.assert_allclose(reveal(ts).numpy(), x, atol=2 / tr.scale)


@proto_params
def test_from_public_and_public_ops(proto, rings):
    jr, tr = rings
    x = normal(2, (3, 4), 2.0)
    c = normal(3, (4,), 2.0)
    js, ts = both(jr, tr, x, 4, proto)
    c2 = normal(32, (3, 4), 2.0)
    jp = j_from_public(jnp.asarray(c2), jr, proto)
    tp = from_public(torch.from_numpy(c2), tr, proto)
    np.testing.assert_array_equal(np.asarray(jp.sh), tp.sh.numpy())
    cases = [
        (lambda: j_ops.add_public(js, 2.5), lambda: ops.add_public(ts, 2.5),
         x + 2.5),
        (lambda: j_ops.add_public(js, jnp.asarray(c)),
         lambda: ops.add_public(ts, torch.from_numpy(c)), x + c),
        (lambda: j_ops.mul_public(js, -1.5), lambda: ops.mul_public(ts, -1.5),
         x * -1.5),
        (lambda: j_ops.mul_public_int(js, 3),
         lambda: ops.mul_public_int(ts, 3), x * 3),
        (lambda: j_ops.neg(js), lambda: ops.neg(ts), -x),
        (lambda: j_ops.add(js, jp), lambda: ops.add(ts, tp), x + c2),
    ]
    for jfn, tfn, want in cases:
        _, out, _ = run(proto, jfn, tfn)
        assert out.proto == proto and out.n_parties == ts.n_parties
        np.testing.assert_allclose(reveal(out).numpy(), want,
                                   atol=8 / tr.scale)


# ---------------------------------------------------------------------------
# the helpers the JAX protocol tests hold
# ---------------------------------------------------------------------------

def test_triple_bytes_equals_jax():
    for shapes in (((4,), (4,), (4,)), ((3, 5), (5, 2), (3, 2)),
                   ((2, 8, 4), (4, 4), (2, 8, 4))):
        for jr, tr in RINGS.values():
            assert beaver.triple_bytes(*shapes, tr) == \
                j_beaver.triple_bytes(*shapes, jr)
    assert beaver.triple_bytes((4,), (4,), (4,), RING64) == 2 * 8 * 12


@proto_params
def test_matmul_public(proto, rings):
    jr, tr = rings
    x, w = normal(27, (2, 3, 6)), normal(28, (6, 4))
    jx, tx = both(jr, tr, x, 29, proto)
    before = kops.rmm_stats()["ref"]
    _, tz, _ = run(proto, lambda: j_ops.matmul_public(jx, jnp.asarray(w)),
                   lambda: ops.matmul_public(tx, w))
    assert kops.rmm_stats()["ref"] == before + 1
    assert tz.fb == 2 * tr.frac_bits
    np.testing.assert_allclose(reveal(tz).numpy(), x @ w, atol=16 / tr.scale)
    # a pre-encoded weight, on an operand at 2f (the headroom plan
    # forces it first, with the key)
    jp = j_ops.mul(jx, jx, jax.random.key(30))
    tp = ops.mul(tx, tx, prng.key(30))
    enc = normal(31, (6, 2))
    jenc, tenc = jr.encode(jnp.asarray(enc)), tr.encode(torch.from_numpy(enc))
    np.testing.assert_array_equal(np.asarray(jenc), tenc.numpy())
    run(proto, lambda: j_ops.matmul_public(jp, None, key=jax.random.key(32),
                                           w_encoded=jenc),
        lambda: ops.matmul_public(tp, None, key=prng.key(32),
                                  w_encoded=tenc))
