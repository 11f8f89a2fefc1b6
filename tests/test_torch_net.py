"""The port's real-wire runtime (`repro_torch.net`) against the JAX
package's `repro.net`.

  * the transport primitives on the port's side: LocalTransport's FIFO,
    kind demux and timeout, TokenBucket on a fake clock (the same sleeps
    as JAX's bucket), free_ports, and the frame-length check
    (`wire`-marked: a socket pair);
  * wire capture: the tapes the port and JAX record from the same keys
    for `tests/test_net.py`'s ops (mul, force, reveal), for all four
    protocols on RING32 and RING64, are equal flight for flight (op,
    rounds, nbytes, tag) and message for message (src, dst, bytes,
    sub-round); `compile_plan` and `expected_digests` equal JAX's, and a
    local replay gives the deterministic fields of JAX's WireReport;
  * the capture's narrowed fallback: filler only for a vmapped lane or a
    meta tensor, a concrete tensor that cannot be read raises;
  * `import repro_torch.net, repro_torch.runtime` in a fresh interpreter
    imports neither torch nor jax;
  * `wire`-marked: one socket replay each of a 2pc and a 3pc tape over
    spawned party processes.

RING64 runs the JAX side under a test-scoped 64-bit mode (the installed
jax has no `jax.experimental.enable_x64`; the tests alias it).
"""
import contextlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import net as j_net
from repro.mpc import comm as j_comm, ops as j_ops, sharing as j_sharing
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro.net import transport as j_tp
from repro_torch import net
from repro_torch.mpc import comm, ops, prng, sharing
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.net import transport as tp

RINGS = {32: (J_RING32, RING32), 64: (J_RING64, RING64)}
PROTOS = ("2pc", "3pc", "spdz2pc", "aby3trunc")
REPORT_FIELDS = ("mode", "n_parties", "n_flights", "n_msgs", "tape_nbytes",
                 "wire_nbytes", "digests_ok", "bytes_match")


@contextlib.contextmanager
def x64(bits):
    """JAX's 64-bit mode for RING64, with `jax.experimental.enable_x64`
    aliased for the package's own `x64_scope`."""
    if bits != 64:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        with jax.enable_x64():
            yield


def port_capture(proto, bits=64):
    """`tests/test_net.py`'s capture on the port: share, mul, force and
    reveal under a ledger and a wire tape."""
    ring = RINGS[bits][1]
    x = sharing.share(prng.key(0), torch.arange(12.0).reshape(3, 4), ring,
                      proto)
    tape = comm.WireTape(x.backend.n_wire_parties)
    with comm.ledger_scope() as led, comm.wire_tape_scope(tape):
        y = ops.mul(x, x, prng.key(1))
        y = ops.force(y, prng.key(2))
        sharing.reveal(y)
    return led, tape


def jax_capture(proto, bits=64):
    """The same capture on the JAX package, from the same keys."""
    ring = RINGS[bits][0]
    with x64(bits):
        x = j_sharing.share(jax.random.key(0),
                            jnp.arange(12.0).reshape(3, 4), ring, proto)
        tape = j_comm.WireTape(x.backend.n_wire_parties)
        with j_comm.ledger_scope() as led, j_comm.wire_tape_scope(tape):
            y = j_ops.mul(x, x, jax.random.key(1))
            y = j_ops.force(y, jax.random.key(2))
            j_sharing.reveal(y)
    return led, tape


def flights(tape):
    return [(f.op, f.rounds, f.nbytes, f.tag,
             [(m.src, m.dst, m.data, m.rnd) for m in f.msgs])
            for f in tape.flights]


def report_fields(rep):
    d = rep.as_dict()
    return {k: d[k] for k in REPORT_FIELDS}


@pytest.fixture(scope="module")
def tapes():
    """(proto, bits) -> ((port ledger, port tape), (JAX ledger, JAX
    tape)), captured once for the module."""
    return {(proto, bits): (port_capture(proto, bits),
                            jax_capture(proto, bits))
            for proto in PROTOS for bits in RINGS}


cases = pytest.mark.parametrize("proto,bits", [(p, b) for p in PROTOS
                                               for b in RINGS])


# ---------------------------------------------------------------------------
# transport primitives
# ---------------------------------------------------------------------------

def test_local_transport_roundtrip_fifo():
    t = net.LocalTransport(2)
    t.send(0, 1, b"first")
    t.send(0, 1, b"second")
    t.send(1, 0, b"back")
    assert t.recv(1, 0) == b"first"
    assert t.recv(1, 0) == b"second"
    assert t.recv(0, 1) == b"back"
    assert t.total_data_bytes == len(b"first" + b"second" + b"back")
    assert t.data_bytes[0, 1] == 11


def test_local_transport_kinds_demuxed():
    t = net.LocalTransport(2)
    t.send(1, 0, b"", kind=tp.BEAT)
    t.send(1, 0, b"payload", kind=tp.DATA)
    assert t.recv(0, 1, kind=tp.DATA) == b"payload"
    assert t.try_recv(0, 1, kind=tp.BEAT) == b""
    assert t.try_recv(0, 1, kind=tp.BEAT) is None
    assert t.total_data_bytes == 7


def test_local_transport_timeout_raises():
    with pytest.raises(net.WireError):
        net.LocalTransport(2).recv(0, 1, timeout=0.01)


@pytest.mark.parametrize("rate,burst,frames", [
    (1000.0, 100.0, (100, 500)), (1e8, None, (70_000, 5_000_000, 1)),
    (250.0, 10.0, (3, 40, 40, 9))])
def test_token_bucket_paces_as_jax(rate, burst, frames):
    """Both buckets on one fake clock sequence: the same sleeps."""
    def run(cls):
        now, slept = [0.0], []

        def sleep(dt):
            slept.append(dt)
            now[0] += dt
        b = cls(rate_Bps=rate, burst=burst, clock=lambda: now[0],
                sleep=sleep)
        waited = [b.throttle(n) for n in frames]
        return waited, slept
    assert run(tp.TokenBucket) == run(j_tp.TokenBucket)
    if burst == 100.0:
        waited, _ = run(tp.TokenBucket)
        assert waited[0] == 0.0 and waited[1] == pytest.approx(0.5)


def test_free_ports_distinct():
    ports = tp.free_ports(3)
    assert len(set(ports)) == 3
    assert all(1024 <= p <= 65535 for p in ports)


@pytest.mark.wire
def test_frame_length_is_checked(monkeypatch):
    """A message at or past the !I length field's reach raises WireError
    at `send` (here with the limit patched to 8 bytes), and a message
    under it still arrives."""
    import threading
    monkeypatch.setattr(tp, "MAX_FRAME", 8)
    ports = tp.free_ports(2)
    out = {}

    def party(p):
        t = tp.SocketTransport(2, p, ports)
        try:
            if p == 0:
                with pytest.raises(net.WireError, match="does not fit"):
                    t.send(0, 1, b"x" * 8)
                t.send(0, 1, b"y" * 7)
            else:
                out[p] = t.recv(1, 0, timeout=10.0)
        finally:
            t.close()

    ths = [threading.Thread(target=party, args=(p,)) for p in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30.0)
    assert not any(th.is_alive() for th in ths)
    assert out == {1: b"y" * 7}


# ---------------------------------------------------------------------------
# capture against JAX's, plan, digests, local replay
# ---------------------------------------------------------------------------

@cases
def test_tapes_equal_jax_message_for_message(tapes, proto, bits):
    (led, tape), (j_led, j_tape) = tapes[proto, bits]
    assert tape.n_parties == j_tape.n_parties
    assert flights(tape) == flights(j_tape)
    assert tape.nbytes == j_tape.nbytes == led.nbytes == j_led.nbytes
    assert tape.link_frames() == j_tape.link_frames()
    assert tape.link_nbytes() == j_tape.link_nbytes()
    assert net.reconcile(led, tape) == j_net.reconcile(j_led, j_tape)


@cases
def test_plan_and_digests_equal_jax(tapes, proto, bits):
    (_, tape), (_, j_tape) = tapes[proto, bits]
    n = tape.n_parties
    for p in range(n):
        assert net.compile_plan(tape, p) == j_net.compile_plan(j_tape, p)
    assert net.expected_digests(tape, n) == \
        j_net.expected_digests(j_tape, n)


@cases
def test_local_replay_report_equals_jax(tapes, proto, bits):
    (led, tape), (_, j_tape) = tapes[proto, bits]
    rep = net.PartyRuntime(tape, mode="local", beat_every=1).execute()
    j_rep = j_net.PartyRuntime(j_tape, mode="local", beat_every=1).execute()
    assert report_fields(rep) == report_fields(j_rep)
    assert rep.bytes_match and rep.digests_ok
    assert rep.wire_nbytes == led.nbytes
    assert rep.suspects == [] and rep.beats_seen > 0


def test_reconcile_detects_divergence():
    led, tape = port_capture("2pc")
    f = tape.flights[0]
    tape.flights[0] = comm.WireFlight(f.op, f.rounds, f.nbytes + 8, f.tag,
                                      f.msgs)
    with pytest.raises(net.WireError):
        net.reconcile(led, tape)


# ---------------------------------------------------------------------------
# the capture's fallback: abstract values only
# ---------------------------------------------------------------------------

def test_unreadable_concrete_tensor_raises():
    """A concrete CPU tensor numpy cannot read (bfloat16) raises; it is
    never replaced by filler that would still reconcile."""
    x = torch.zeros(4, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        comm.normalize_payload([(0, 1, x)], nbytes=8, rounds=1, n_parties=2)


@pytest.mark.parametrize("abstract", ["vmap", "meta"])
def test_abstract_payload_gets_filler(abstract):
    def msgs(x):
        return comm.normalize_payload([(0, 1, x)], nbytes=32, rounds=1,
                                      n_parties=2)
    if abstract == "meta":
        got = msgs(torch.zeros(8, dtype=torch.int32, device="meta"))
    else:
        seen = []
        torch.func.vmap(lambda x: seen.append(msgs(x)) or x)(
            torch.ones(3, 8, dtype=torch.int32))
        (got,) = seen
    assert got == comm.synth_msgs(32, 1, 2)


def test_concrete_payload_ships_its_bytes():
    x = torch.arange(8, dtype=torch.int32)
    (m,) = comm.normalize_payload([(0, 1, x)], nbytes=32, rounds=1,
                                  n_parties=2)
    assert m.data == x.numpy().tobytes()


# ---------------------------------------------------------------------------
# the package stays torch-free
# ---------------------------------------------------------------------------

def test_net_and_runtime_import_neither_torch_nor_jax():
    code = ("import sys, repro_torch.net, repro_torch.runtime; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# socket replay: spawned parties over localhost TCP (marked)
# ---------------------------------------------------------------------------

@pytest.mark.wire
@pytest.mark.parametrize("proto", ["2pc", "3pc"])
def test_socket_replay_executes_tape(proto):
    led, tape = port_capture(proto)
    rep = net.PartyRuntime(tape, mode="socket", beat_every=1,
                           profile=comm.PROFILES["pod_dcn"]).execute()
    assert rep.bytes_match and rep.digests_ok
    assert rep.wire_nbytes == led.nbytes
    assert rep.mode == "socket" and rep.n_parties == tape.n_parties
    assert rep.wire_makespan_s > 0.0
