"""The port's chaos-hardened wire (`repro_torch.net.faults`, the reliable
transport and the supervisor) against the JAX package's.

  * `FaultPlan.from_tape(seed, tape).to_json()` equals JAX's for the
    same tape (test_torch_net.py holds the two packages' tapes equal) and
    seeds, with the crash mid-phase, at the boundary, and with a slow
    party; the JSON round trip and `without_crash`;
  * `filter_tape` equals JAX's, message for message;
  * the reliable transport dedups a duplicate and recovers a dropped
    frame, goodput and the RETRANS channel apart;
  * local chaos replays reconcile; a crash resumes from its cursor; a
    crash at the boundary completes 2-of-3; a crash plan without a
    recovery policy raises;
  * `wire`+`chaos`-marked: one socket replay under drops, a spike, a
    reset and a crash, recovered by a respawn.
"""
import json

import pytest

from repro.net import faults as j_fx, runtime as j_runtime
from repro_torch import net
from repro_torch.mpc import comm
from repro_torch.net import faults as fx
from repro_torch.net import transport as tp
from test_torch_net import flights, jax_capture, port_capture

SEEDS = (0, 7, 123, 2024)


@pytest.fixture(scope="module")
def tapes():
    """proto -> (port tape, JAX tape), RING64, captured once."""
    return {proto: (port_capture(proto)[1], jax_capture(proto)[1])
            for proto in ("2pc", "3pc")}


@pytest.mark.parametrize("proto", ["2pc", "3pc"])
@pytest.mark.parametrize("kw", [{}, {"crash_at_boundary": True},
                                {"slow_party": 1, "slow_s": 0.01},
                                {"n_drops": 0, "n_spikes": 0, "n_resets": 0,
                                 "crash_at_boundary": True}])
def test_fault_plan_json_equals_jax(tapes, proto, kw):
    tape, j_tape = tapes[proto]
    for seed in SEEDS:
        plan = fx.FaultPlan.from_tape(seed, tape, **kw)
        want = j_fx.FaultPlan.from_tape(seed, j_tape, **kw)
        assert plan.to_json() == want.to_json()
        assert plan.n_faults == want.n_faults
        assert fx.FaultPlan.from_json(plan.to_json()) == plan
        assert plan.without_crash().crash is None
        assert plan.without_crash().drops == plan.drops


def test_fault_plan_is_deterministic_and_seeded(tapes):
    tape, _ = tapes["3pc"]
    a = fx.FaultPlan.from_tape(123, tape)
    assert a == fx.FaultPlan.from_tape(123, tape)
    assert a.n_faults >= 4 and a.crash is not None and a.crash[1] >= 1
    assert fx.FaultPlan.from_tape(124, tape) != a
    raw = json.loads(a.to_json())
    assert raw["seed"] == 123 and raw["crash"] == list(a.crash)


def test_injected_crash_is_not_an_exception():
    assert issubclass(fx.InjectedCrash, BaseException)
    assert not issubclass(fx.InjectedCrash, Exception)


@pytest.mark.parametrize("dead", [0, 1, 2])
def test_filter_tape_equals_jax(tapes, dead):
    tape, j_tape = tapes["3pc"]
    got = net.filter_tape(tape, dead)
    want = j_runtime.filter_tape(j_tape, dead)
    assert flights(got) == flights(want)
    assert len(got.flights) == len(tape.flights)
    assert got.nbytes == want.nbytes
    assert all(dead not in (m.src, m.dst) for f in got.flights
               for m in f.msgs)
    assert flights(tape) == flights(j_tape)       # the original untouched


# ---------------------------------------------------------------------------
# reliable delivery
# ---------------------------------------------------------------------------

def test_reliable_dedups_duplicate_frames():
    base = tp.LocalTransport(2)
    rel = tp.ReliableTransport(base)
    rel.send(0, 1, b"first")
    base.send(0, 1, b"first", tp.DATA, seq=0)     # wire-level duplicate
    rel.send(0, 1, b"second")
    assert rel.recv(1, 0, timeout=1.0) == b"first"
    assert rel.recv(1, 0, timeout=1.0) == b"second"
    assert rel.dup_frames == 1


def test_reliable_recovers_a_drop_on_the_retrans_channel():
    base = tp.LocalTransport(2)
    chaos = fx.ChaosTransport(base, fx.FaultPlan(seed=0,
                                                 drops={(0, 1): (1,)}))
    rel = tp.ReliableTransport(chaos, rto_s=0.01)
    payloads = [b"a" * 10, b"b" * 10, b"c" * 10]
    for p in payloads:
        rel.send(0, 1, p)
    assert rel.recv(1, 0, timeout=1.0) == payloads[0]
    with pytest.raises(tp.WireError):
        rel.recv(1, 0, timeout=0.05)              # gap: frame 1 dropped
    rel._service_control(0)                       # the sender resends
    assert rel.recv(1, 0, timeout=1.0) == payloads[1]
    assert rel.recv(1, 0, timeout=1.0) == payloads[2]
    assert chaos.dropped == 1 and rel.retries > 0
    assert base.total_data_bytes == 30 and base.total_retrans_bytes > 0


# ---------------------------------------------------------------------------
# chaos replays, local mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proto", ["2pc", "3pc"])
def test_local_chaos_replay_reconciles(tapes, proto):
    tape, _ = tapes[proto]
    plan = fx.FaultPlan.from_tape(123, tape, crash=False)
    rep = net.PartyRuntime(tape, mode="local", fault_plan=plan).execute()
    assert rep.bytes_match and rep.digests_ok
    assert rep.wire_nbytes == tape.nbytes
    assert rep.retries > 0 and rep.retrans_bytes > 0
    assert rep.faults_injected == plan.n_faults
    assert rep.fault_plan == plan.to_json()


def test_local_crash_resumes_from_its_cursor(tapes):
    tape, _ = tapes["3pc"]
    plan = fx.FaultPlan.from_tape(123, tape)
    assert plan.crash is not None and plan.crash[1] >= 1    # mid-phase
    rep = net.PartyRuntime(tape, mode="local", fault_plan=plan,
                           recover=True).execute()
    assert rep.bytes_match and rep.digests_ok
    assert rep.respawns == 1 and rep.recovery_time_s > 0
    assert not rep.degraded


def test_degraded_completes_two_of_three(tapes):
    tape, _ = tapes["3pc"]
    plan = fx.FaultPlan.from_tape(7, tape, n_drops=0, n_spikes=0,
                                  n_resets=0, crash_at_boundary=True)
    assert plan.crash is not None and plan.crash[1] == 0
    rep = net.PartyRuntime(tape, mode="local", fault_plan=plan,
                           degraded=True).execute()
    assert rep.degraded and rep.dead_parties == [plan.crash[0]]
    assert rep.bytes_match and rep.digests_ok
    assert rep.tape_nbytes == net.filter_tape(tape, plan.crash[0]).nbytes
    assert rep.respawns == 0


def test_crash_without_a_recovery_policy_raises(tapes):
    tape, _ = tapes["3pc"]
    with pytest.raises(ValueError, match="recover=True"):
        net.PartyRuntime(tape, mode="local",
                         fault_plan=fx.FaultPlan.from_tape(123, tape))


# ---------------------------------------------------------------------------
# socket chaos: real processes, a real reset and a respawn (marked)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.wire
def test_socket_chaos_replay_recovers_a_crash(tapes):
    tape, _ = tapes["3pc"]          # 2pc's tape is too short for a crash
    plan = fx.FaultPlan.from_tape(123, tape)
    assert plan.crash is not None
    rep = net.PartyRuntime(tape, mode="socket",
                           profile=comm.PROFILES["pod_dcn"], timeout_s=60.0,
                           fault_plan=plan, recover=True).execute()
    assert rep.bytes_match and rep.digests_ok
    assert rep.wire_nbytes == tape.nbytes
    assert rep.retries > 0 and rep.respawns == 1
    assert rep.recovery_time_s > 0
