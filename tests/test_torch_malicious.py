"""The protocol backends' own contracts on the port: the JAX package's
tests/test_malicious.py, test_protocols.py, test_scale.py and
test_conformance.py, held by the port alone (its bitwise parity with
the JAX package is test_torch_protocols.py and test_torch_proto*.py).

  1. MAC PLUMBING — honest partial opens under a `mac_scope` verify
     (n_opened > 0); one flipped bit in any of the four rows of an
     opened tensor aborts the batched check with `MacCheckError`; so
     does a tampered Beaver opening; the obligations are 0-d device
     flags, checked in order; tensors under `torch.func.vmap` and meta
     tensors count in `n_traced`; spdz2pc truncation needs a key; the
     semi-honest backends accept the same flip silently.
  2. PRICING — authenticated mul = MAC'd triple + sacrificed triple
     (offline) + sacrifice flight + Beaver open; spdz2pc truncation pays
     a MAC'd dealer pair and an opening on both rings; the MAC check is
     constant-size; aby3trunc's trunc2 is 2 rounds with no dealer; a
     keyed 3pc truncation prices its re-replication bytes; 3pc has no
     offline bytes.
  3. REPLICATED SHARING — layout, uniform lone components, the open
     wire model, mul and matmul against clear, ReLU, public ops keep the
     protocol, mixed-protocol inputs rejected, `resolve_engine`.
  4. SHAPE OPS AND SCALE — broadcast, moveaxis/swapaxes, index and
     getitem, reshape and sum against ClearEngine, scale metadata
     through `with_sh`, layout ops and the tree helpers, on all four
     backends; the RING64 3f deferral only on exact-trunc backends.
  5. CONFORMANCE — every backend on both rings: roundtrip, open bytes
     equal to `costs.open_cost`, mul/matmul/trunc within the scheme's
     bound (3pc RING32 may wrap), mixed-exponent linear ops, each op's
     ledger equal to its `costs.*_cost` record for record.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.tree import tree_leaves, tree_rebuild
from repro_torch.engine import ClearEngine, MPCEngine
from repro_torch.engine.base import resolve_engine
from repro_torch.mpc import compare, costs, ops as mops, prng, protocols
from repro_torch.mpc.comm import ledger_scope
from repro_torch.mpc.protocols.spdz2pc import (MacCheckError, mac_key,
                                               mac_scope, tamper_scope)
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.mpc.sharing import open_, reveal, share

K = prng.key(0)
RINGS = {"ring64": RING64, "ring32": RING32}
PROTOS = sorted(protocols.PROTOCOLS)
ring_params = pytest.mark.parametrize("ring", list(RINGS.values()),
                                      ids=list(RINGS))
proto_params = pytest.mark.parametrize("proto", PROTOS)


def _k(i):
    return prng.fold_in(K, i)


def _vals(i, shape, scale=3.0):
    return torch.from_numpy((np.random.default_rng(i).normal(size=shape)
                             * scale).astype(np.float32))


def bump(row, col, v):
    """The adversary: add v to one element of one row of the next
    opened tensor."""
    def fn(sh):
        sh = sh.clone()
        sh.view(sh.shape[0], -1)[row, col] += v
        return sh
    return fn


def tol(ring, ulp=4):
    return ulp / ring.scale


def _assert_close(got, want, ring, proto, ulp=8):
    """3pc on RING32 truncates by a probabilistic regroup that wraps with
    probability |enc|/2^32 an element (a 2^(32-2f) error when it does);
    every other scheme and ring is within a few ulp."""
    err = (got.double() - want.double()).abs()
    if proto == "3pc" and ring.bits == 32:
        wrapped = err > 1.0
        assert wrapped.double().mean() < 0.5, proto
        err = err[~wrapped]
        if err.numel() == 0:
            return
    assert float(err.max()) < tol(ring, ulp), (proto, ring.bits)


# ---------------------------------------------------------------------------
# 1. MAC plumbing
# ---------------------------------------------------------------------------

class TestMacCheck:
    def test_registry_and_layout(self):
        assert protocols.get("spdz2pc").n_parties == 4
        s = share(_k(0), torch.tensor([1.5, -2.25]), RING64, "spdz2pc")
        assert s.sh.shape == (4, 2)
        alpha, a0, a1 = mac_key(RING64)
        assert torch.equal(a0 + a1, alpha)
        assert torch.equal(s.sh[2] + s.sh[3], alpha * (s.sh[0] + s.sh[1]))

    def test_honest_opens_verify(self):
        with mac_scope() as st:
            got = reveal(share(_k(1), torch.tensor([3.0, -1.25]), RING64,
                               "spdz2pc"))
            assert st.n_opened > 0 and st.n_traced == 0
            st.verify()
            assert st.flags == []
        torch.testing.assert_close(got, torch.tensor([3.0, -1.25],
                                                     dtype=torch.float64),
                                   atol=1e-3, rtol=0)

    @pytest.mark.parametrize("row", [0, 1, 2, 3])
    def test_single_bit_flip_aborts(self, row):
        """One bit of a value row (0, 1) or a MAC row (2, 3) of the
        opened tensor: the batched check aborts."""
        x = share(_k(2), torch.tensor([1.0, 2.0, 3.0]), RING64, "spdz2pc")
        with mac_scope() as st:
            with tamper_scope(bump(row, 1, 1 << 3)):
                reveal(x)
            with pytest.raises(MacCheckError, match="tampered"):
                st.verify()

    def test_tampered_mul_opening_aborts(self):
        x = share(_k(3), torch.ones(4), RING64, "spdz2pc")
        with mac_scope() as st:
            with tamper_scope(bump(1, 0, 1)):
                mops.force(mops.mul(x, x, _k(4)), _k(5))
            assert st.n_opened > 0
            with pytest.raises(MacCheckError, match="'beaver_mul'"):
                st.verify()

    def test_honest_mul_chain_verifies(self):
        x = share(_k(6), torch.tensor([0.5, -1.5]), RING64, "spdz2pc")
        with mac_scope() as st:
            z = mops.force(mops.mul(x, x, _k(7)), _k(8))
            got = reveal(z)
            assert st.n_opened >= 3         # beaver, trunc, open
            st.verify()
        assert torch.allclose(got, torch.tensor([0.25, 2.25],
                                                dtype=torch.float64),
                              atol=1e-3)

    def test_trunc_requires_key(self):
        x = share(_k(9), torch.ones(2), RING64, "spdz2pc")
        with pytest.raises(ValueError, match="MAC-preserving"):
            protocols.get("spdz2pc").trunc(x, None)

    def test_obligations_are_flags_checked_in_order(self):
        """Each obligation is a 0-d bool flag; verify names the first
        failing op in the order the opens ran."""
        x = share(_k(10), torch.ones(3), RING32, "spdz2pc")
        with mac_scope() as st:
            reveal(x)
            with tamper_scope(bump(0, 0, 1)):
                mops.force(mops.mul(x, x, _k(11)), _k(12))
            assert all(f.dtype == torch.bool and f.dim() == 0
                       for _, f in st.flags)
            assert [op for op, _ in st.flags] == \
                ["open", "beaver_mul", "beaver_mul", "trunc_open"]
            with pytest.raises(MacCheckError, match="'beaver_mul'"):
                st.verify()

    def test_vmap_and_meta_obligations_are_counted_not_read(self):
        keys = prng.split(_k(13), 2)
        xs = torch.stack([share(keys[i], torch.ones(3), RING64,
                                "spdz2pc").sh for i in range(2)], 1)
        b = protocols.get("spdz2pc")
        with mac_scope() as st:
            torch.func.vmap(b.reconstruct, in_dims=1)(xs)
            assert (st.n_opened, st.n_traced, st.flags) == (1, 1, [])
            b.reconstruct(torch.empty((4, 3), dtype=torch.int64,
                                      device="meta"))
            assert (st.n_opened, st.n_traced, st.flags) == (2, 2, [])
            b.reconstruct(xs[:, 0])
            assert (st.n_opened, st.n_traced, len(st.flags)) == (3, 2, 1)
            st.verify()

    @pytest.mark.parametrize("proto", [p for p in PROTOS
                                       if p != "spdz2pc"])
    def test_semi_honest_backends_accept_tamper_silently(self, proto):
        v = torch.tensor([1.5, -2.25])
        x = share(_k(37), v, RING64, proto)
        honest = reveal(x)
        bad = x.with_sh(bump(0, 0, 1 << 8)(x.sh))
        tampered = reveal(bad)                 # no exception: accepted
        assert float((honest - v).abs().max()) < tol(RING64, 2)
        assert tampered[0] != honest[0] and tampered[1] == honest[1]


# ---------------------------------------------------------------------------
# 2. pricing
# ---------------------------------------------------------------------------

class TestPricing:
    def test_mul_records_sacrifice_and_doubled_triples(self):
        n = 6
        x = share(_k(20), torch.ones(n), RING64, "spdz2pc")
        with ledger_scope() as led:
            mops.mul(x, x, _k(21))
        assert [r.op for r in led.records] == \
            ["offline.mul_triple", "offline.sacrifice_triple",
             "sacrifice", "beaver_mul"]
        assert [r.tag for r in led.records] == \
            ["offline", "offline", "bw", "bw"]
        eb = RING64.elem_bytes
        assert led.offline_nbytes == 2 * (4 * eb * 3 * n)
        assert led.records[2].nbytes == led.records[3].nbytes == 4 * eb * n
        assert led.rounds == 2

    @ring_params
    def test_trunc_pays_dealer_pair_on_both_rings(self, ring):
        x = share(_k(22), torch.ones(5), ring, "spdz2pc")
        p = mops.mul(x, x, _k(23))
        with ledger_scope() as led:
            mops.force(p, _k(24))
        assert [r.op for r in led.records] == \
            ["offline.trunc_pair", "trunc_open"]
        assert led.rounds == 1
        assert led.offline_nbytes == 4 * ring.elem_bytes * 2 * 5
        if ring is RING64:                     # semi-honest: ledger-silent
            q = mops.mul(share(_k(25), torch.ones(5), ring),
                         share(_k(26), torch.ones(5), ring), _k(27))
            with ledger_scope() as led2:
                mops.force(q, _k(28))
            assert led2.records == []

    def test_mac_check_flight_is_constant_size(self):
        with ledger_scope() as led:
            protocols.get("spdz2pc").mac_check_flight(RING64)
        assert [r.op for r in led.records] == ["offline.mac_key",
                                               "mac_check"]
        assert led.rounds == 1
        assert led.nbytes == 4 * RING64.elem_bytes
        assert led.offline_nbytes == 2 * RING64.elem_bytes

    def test_aby3_trunc2_two_rounds_no_dealer(self):
        x = share(_k(29), torch.ones(5), RING32, "aby3trunc")
        p = mops.mul(x, x, _k(30))
        with ledger_scope() as led:
            mops.force(p, _k(31))
        (rec,) = led.records
        assert rec.op == "trunc2" and rec.rounds == 2
        assert rec.nbytes == 6 * RING32.elem_bytes * 5
        assert led.offline_nbytes == 0

    def test_3pc_force_prices_rereplication_bytes(self):
        s = share(_k(40), torch.tensor([1.0, 2.0, 3.0]), RING64, "3pc")
        z = mops.mul(s, s, _k(41))
        with ledger_scope() as led:
            mops.force(z, _k(42))
        (rec,) = led.records
        assert (rec.op, rec.rounds, rec.tag) == ("trunc_reshare", 0, "bw")
        assert rec.nbytes == RING64.elem_bytes * 3
        assert led.offline_nbytes == 0

    def test_3pc_has_zero_offline(self):
        x = share(_k(23), torch.ones(6), RING32, "3pc")
        with ledger_scope() as led:
            z = mops.mul(x, x, _k(24))
            mops.matmul(z.reshape(2, 3), share(_k(25), torch.ones(3, 2),
                                               RING32, "3pc"), _k(26))
        assert led.offline_nbytes == 0
        assert all(r.tag != "offline" for r in led.records)


# ---------------------------------------------------------------------------
# 3. replicated sharing
# ---------------------------------------------------------------------------

class TestReplicatedSharing:
    def test_share_roundtrip_and_layout(self):
        x = torch.tensor([1.5, -2.25, 1000.0, -0.0001, 0.0])
        s = share(_k(0), x, RING64, "3pc")
        assert s.sh.shape == (3, 5) and s.n_parties == 3 and s.proto == "3pc"
        assert torch.allclose(reveal(s), x.double(), atol=1e-3)

    def test_single_component_is_uniform(self):
        s = share(_k(1), torch.full((4096,), 7.25), RING64, "3pc")
        for i in range(3):
            assert float(s.sh[i].double().std()) > 2 ** 60, i

    def test_open_wire_model(self):
        for proto, parties in (("2pc", 2), ("3pc", 3), ("aby3trunc", 3),
                               ("spdz2pc", 2)):
            with ledger_scope() as led:
                reveal(share(_k(2), torch.ones(10), RING64, proto))
            (rec,) = led.records
            assert rec.nbytes == parties * RING64.elem_bytes * 10, proto

    @ring_params
    def test_mul_matches_2pc_values(self, ring):
        x = torch.tensor([1.5, -2.0, 0.25, 3.0])
        y = torch.tensor([2.0, 1.5, -4.0, 0.5])
        got = reveal(mops.mul(share(_k(3), x, ring, "3pc"),
                              share(_k(4), y, ring, "3pc"), _k(5)))
        assert torch.allclose(got.double(), (x * y).double(),
                              atol=8.0 / ring.scale * 9)

    def test_matmul_and_relu(self):
        a, b = _vals(6, (5, 7), 1.0), _vals(7, (7, 3), 1.0)
        z = reveal(mops.matmul(share(_k(8), a, RING64, "3pc"),
                               share(_k(9), b, RING64, "3pc"), _k(10)))
        assert torch.allclose(z, (a @ b).double(), atol=1e-3)
        x = torch.tensor([-3.0, -0.5, 0.0, 0.5, 3.0])
        r = reveal(compare.relu(share(_k(11), x, RING64, "3pc"), _k(12)))
        assert torch.allclose(r, x.clamp(min=0).double(), atol=1e-3)

    def test_public_ops_preserve_proto(self):
        x = torch.tensor([1.0, -2.0, 3.0])
        xs = share(_k(13), x, RING64, "3pc")
        for out, want in ((mops.add_public(xs, 2.5), x + 2.5),
                          (mops.mul_public(xs, -1.5), x * -1.5),
                          (mops.mul_public_int(xs, 3), x * 3),
                          (mops.neg(xs), -x)):
            assert out.proto == "3pc" and out.n_parties == 3
            assert torch.allclose(reveal(out), want.double(), atol=1e-3)

    def test_mixed_protocol_inputs_rejected(self):
        x2 = share(_k(14), torch.ones(4), RING64, "2pc")
        eng = MPCEngine(protocol="3pc").with_key(_k(15))
        with pytest.raises(ValueError, match="protocol"):
            eng.embed(None, x2, None)

    def test_resolve_engine_protocol(self):
        for proto in PROTOS:
            eng = resolve_engine("mpc", ring=RING32, protocol=proto)
            assert isinstance(eng, MPCEngine)
            assert eng.backend is protocols.get(proto)


# ---------------------------------------------------------------------------
# 4. shape ops and the scale lattice on every backend
# ---------------------------------------------------------------------------

class TestShapeOpsAndScale:
    def _pair(self, proto, val, i=50):
        eng = MPCEngine(protocol=proto).with_key(_k(i))
        return eng, share(_k(i + 1), torch.as_tensor(val, dtype=torch.float32),
                          RING64, proto)

    @proto_params
    def test_broadcast_padded_axes_and_scalar(self, proto):
        ceng = ClearEngine()
        v = torch.arange(4.0)
        eng, s = self._pair(proto, v)
        out = eng.broadcast(s, (3, 4))
        assert out.shape == (3, 4) and out.n_parties == eng.backend.n_parties
        assert torch.allclose(reveal(out), ceng.broadcast(v, (3, 4))
                              .double(), atol=1e-3)
        eng, s = self._pair(proto, 2.5, 52)
        out = eng.broadcast(s, (2, 3))
        assert out.shape == (2, 3)
        assert torch.allclose(reveal(out), torch.full((2, 3), 2.5,
                                                      dtype=torch.float64),
                              atol=1e-3)
        # the qkv-bias party-axis regression: a (P, n) share broadcast to
        # (rows, n) right-aligns the value dims
        b = _vals(6, (8,), 1.0)
        eng, s = self._pair(proto, b, 60)
        assert torch.allclose(reveal(eng.broadcast(s, (6, 8))),
                              b.expand(6, 8).double(), atol=1e-3)

    @proto_params
    def test_moveaxis_swapaxes_index_reshape(self, proto):
        ceng = ClearEngine()
        v = _vals(3, (2, 3, 4), 1.0)
        eng, s = self._pair(proto, v, 54)
        for fn, args in (("moveaxis", (-1, 0)), ("moveaxis", (1, -1)),
                         ("swapaxes", (-1, -2)), ("swapaxes", (0, -1))):
            got = getattr(eng, fn)(s, *args)
            want = getattr(ceng, fn)(v, *args)
            assert got.shape == tuple(want.shape), (fn, args)
            assert torch.allclose(reveal(got), want.double(), atol=1e-3)
        v = _vals(4, (5, 3), 1.0)
        eng, s = self._pair(proto, v, 56)
        for i in (0, 2, -1, -5):
            got = eng.index(s, i)
            assert got.shape == (3,)
            assert torch.allclose(reveal(got), v[i].double(), atol=1e-3)
        sub = s[1:4]
        assert sub.shape == (3, 3) and sub.proto == proto
        assert torch.allclose(reveal(sub), v[1:4].double(), atol=1e-3)
        v = _vals(5, (4, 6), 1.0)
        eng, s = self._pair(proto, v, 58)
        tot = mops.sum_(eng.reshape(s, (2, 2, 6)), axis=-1)
        assert tot.shape == (2, 2)
        assert torch.allclose(reveal(tot), v.reshape(2, 2, 6).sum(-1)
                              .double(), atol=1e-3)

    @proto_params
    def test_scale_metadata_survives_layout(self, proto):
        s = share(_k(2), torch.ones(2, 3), RING64, proto)
        z = mops.mul(s, s, _k(3))              # rides at 2f
        z2 = tree_rebuild({"z": z}, tree_leaves({"z": z}))["z"]
        assert (z2.fb, z2.proto) == (2 * RING64.frac_bits, proto)
        rebuilt = z.with_sh(-z.sh)
        assert (rebuilt.proto, rebuilt.fb, rebuilt.n_parties) == \
            (proto, 2 * RING64.frac_bits, z.n_parties)
        v = _vals(0, (2, 3, 4), 0.5)
        eng = MPCEngine(protocol=proto).with_key(_k(4))
        s = share(_k(5), v, RING64, proto)
        z = mops.mul(s, s, _k(6))
        want = (v * v).double()
        for got, ref in ((eng.moveaxis(z, -1, 0), want.movedim(-1, 0)),
                         (eng.swapaxes(z, -1, -2), want.swapaxes(-1, -2)),
                         (eng.reshape(z, (6, 4)), want.reshape(6, 4)),
                         (eng.broadcast(z, (2, 2, 3, 4)),
                          want.expand(2, 2, 3, 4))):
            assert got.fb == 2 * RING64.frac_bits
            assert torch.allclose(reveal(got), ref, atol=1e-3)

    @pytest.mark.parametrize("proto", ["aby3trunc", "spdz2pc"])
    def test_double_mul_chain_defers_on_ring64(self, proto):
        """3f fits RING64's headroom only on a backend whose truncation
        is exact at any exponent; default 2pc forces back to 2f."""
        vals = torch.tensor([3.0, -2.5, 1.25])
        x, y, z = (share(_k(40 + i), vals, RING64, proto) for i in range(3))
        a = mops.mul(x, y, _k(43))
        assert a.excess == RING64.frac_bits
        with ledger_scope() as led:
            b = mops.mul(a, z, _k(44))
        assert not [r.op for r in led.records if "trunc" in r.op]
        assert b.fb == 3 * RING64.frac_bits
        want = (vals ** 3).double()
        assert torch.allclose(reveal(b), want, atol=2e-2)
        x2, y2, z2 = (share(_k(45 + i), vals, RING64) for i in range(3))
        b2 = mops.mul(mops.mul(x2, y2, _k(48)), z2, _k(49))
        assert b2.fb == 2 * RING64.frac_bits
        assert torch.allclose(reveal(b2), want, atol=2e-2)


# ---------------------------------------------------------------------------
# 5. conformance: every backend, both rings
# ---------------------------------------------------------------------------

def _tuples(records):
    return [(r.rounds, r.nbytes, r.numel, r.flops, r.tag) for r in records]


@proto_params
@ring_params
def test_conformance_roundtrip_and_wire_model(proto, ring):
    v = _vals(1, (5, 3))
    x = share(_k(2), v, ring, proto)
    assert x.sh.shape[0] == protocols.get(proto).n_parties
    assert float((reveal(x) - v.double()).abs().max()) < tol(ring, 2)
    x = share(_k(3), torch.ones(12), ring, proto)
    with ledger_scope() as led:
        open_(x)
    (r,) = led.records
    assert r.rounds == 1
    assert r.nbytes == protocols.get(proto).open_bytes(ring, 12)
    assert _tuples(led.records) == _tuples(
        costs.open_cost(12, ring=ring, protocol=proto).records)


@proto_params
@ring_params
def test_conformance_mul_matmul_trunc(proto, ring):
    a, b = _vals(4, (4, 5)), _vals(5, (4, 5))
    x, y = share(_k(6), a, ring, proto), share(_k(7), b, ring, proto)
    _assert_close(reveal(mops.force(mops.mul(x, y, _k(8)), _k(9))), a * b,
                  ring, proto)
    a, b = _vals(10, (3, 4), 1.0), _vals(11, (4, 2), 1.0)
    x, y = share(_k(12), a, ring, proto), share(_k(13), b, ring, proto)
    _assert_close(reveal(mops.force(mops.matmul(x, y, _k(14)), _k(15))),
                  a @ b, ring, proto, ulp=16)
    a, b = _vals(23, (64,)), _vals(24, (64,))
    x, y = share(_k(25), a, ring, proto), share(_k(26), b, ring, proto)
    f = mops.force(mops.mul(x, y, _k(27)), _k(28))
    assert f.fb == ring.frac_bits
    _assert_close(reveal(f), a * b, ring, proto)


@proto_params
@ring_params
def test_conformance_linear_ops_align_mixed_exponents(proto, ring):
    a, b, c = _vals(16, (6,)), _vals(17, (6,)), _vals(18, (6,))
    x, y, w = (share(_k(19 + i), t, ring, proto)
               for i, t in enumerate((a, b, c)))
    p = mops.mul(x, y, _k(22))
    assert p.excess > 0
    t = tol(ring, 16)
    ab, cd = (a * b).double(), c.double()
    assert float((reveal(mops.add(p, w)) - (ab + cd)).abs().max()) < t
    assert float((reveal(mops.sub(p, w)) - (ab - cd)).abs().max()) < t
    assert float((reveal(mops.concat([p, w], axis=0))
                  - torch.cat([ab, cd])).abs().max()) < t
    assert float((reveal(mops.stack([w, p], axis=0))
                  - torch.stack([cd, ab])).abs().max()) < t


@proto_params
@ring_params
@pytest.mark.parametrize("opname", ["mul", "matmul", "force"])
def test_conformance_op_ledger_matches_mirror(proto, ring, opname):
    if opname == "matmul":
        x = share(_k(29), torch.ones(3, 4), ring, proto)
        y = share(_k(30), torch.ones(4, 2), ring, proto)
        with ledger_scope() as led:
            mops.matmul(x, y, _k(31))
        want = costs.matmul_cost(1, 3, 4, 2, ring=ring, protocol=proto,
                                 inline_trunc=False)
    elif opname == "mul":
        x = share(_k(32), torch.ones(7), ring, proto)
        with ledger_scope() as led:
            mops.mul(x, x, _k(33))
        want = costs.mul_cost(7, ring=ring, protocol=proto,
                              inline_trunc=False)
    else:
        x = share(_k(34), torch.ones(7), ring, proto)
        p = mops.mul(x, x, _k(35))
        with ledger_scope() as led:
            mops.force(p, _k(36))
        want = costs.trunc_cost(7, ring=ring, protocol=proto)
    assert _tuples(led.records) == _tuples(want.records), \
        (proto, ring.bits, opname, [r.op for r in led.records])
