"""The port's wave executor on a real wire (`ExecConfig.wire`), at a tiny
width (d_model 32, 2 heads, seq 8: benchmarks/common.py's calibration
geometry), on the CPU. No JAX forward runs here: the wired phase is held
to the port's own unwired one, which the sieve tests hold to JAX's.

  * 2pc and 3pc under `wire="local"`: scores bitwise equal to the unwired
    run's, the ledger agrees with the schedule, the replay's goodput
    equals the ledger's bytes and every payload digest matches;
  * the same under `chaos_seed` (2pc: drops, a spike, a reset, a crash
    recovered by a respawn), and 3pc `degraded` (2-of-3 after a crash at
    the phase boundary, bytes against the filtered tape);
  * an unknown wire mode and `chaos_seed` without a wire raise
    ValueError; a wire forces the eager per-lane schedule;
  * `PhaseReport.as_dict(net=POD_DCN)` has the JAX package's keys;
  * `wire`-marked: the socket wire at pod_dcn, one spawned process a
    party.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import iosched as j_iosched
from repro.core.executor import PhaseReport as JPhaseReport
from repro.mpc.comm import Ledger as JLedger, POD_DCN as J_POD_DCN
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import iosched, proxy
from repro_torch.core.executor import ExecConfig, PhaseReport, WaveExecutor
from repro_torch.core.proxy import ProxySpec
from repro_torch.mpc import prng
from repro_torch.mpc.comm import POD_DCN, Ledger

CFG = dataclasses.replace(TINY_TARGET, vocab_size=64, n_layers=1, d_model=32,
                          n_heads=2, n_kv_heads=2, d_head=16, d_ff=64)
SPEC = ProxySpec(1, 2, 4)
SEQ, BATCH, WAVE = 8, 8, 2


@pytest.fixture(scope="module")
def setup():
    pp = proxy.random_proxy(torch.Generator().manual_seed(0), CFG, SPEC, SEQ,
                            2, device="cpu")
    tok = np.random.default_rng(1).integers(0, CFG.vocab_size, (16, SEQ))
    return pp, tok


def phase(setup, protocol, **kw):
    pp, tok = setup
    ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, protocol=protocol,
                                 device="cpu", **kw))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ent = ex.score_phase(prng.key(2), pp, CFG, tok, SPEC)
    finally:
        torch.set_num_threads(threads)
    return ent.sh, ex.reports[-1]


@pytest.fixture(scope="module")
def unwired(setup):
    return {p: phase(setup, p) for p in ("2pc", "3pc")}


@pytest.mark.parametrize("protocol,kw", [
    ("2pc", {}), ("3pc", {}), ("2pc", {"chaos_seed": 123})])
def test_local_wire_bitwise_and_reconciled(setup, unwired, protocol, kw):
    ref, rep0 = unwired[protocol]
    got, rep = phase(setup, protocol, wire="local", **kw)
    assert torch.equal(ref, got)
    assert rep0.wire is None and rep.wire is not None
    assert rep.agrees()
    w = rep.wire
    assert w.bytes_match and w.digests_ok
    assert w.wire_nbytes == rep.ledger.nbytes == rep0.ledger.nbytes
    assert w.n_flights == len([r for r in rep.ledger.records
                               if r.tag != "offline"])
    assert w.wire_makespan_s > 0.0
    if kw:
        assert w.faults_injected > 0 and w.retries > 0
        assert w.respawns == 1 and w.recovery_time_s > 0
        assert w.fault_plan is not None and not w.degraded


def test_degraded_two_of_three(setup, unwired):
    ref, _ = unwired["3pc"]
    got, rep = phase(setup, "3pc", wire="local", chaos_seed=123,
                     degraded=True)
    assert torch.equal(ref, got)
    w = rep.wire
    assert w.degraded and len(w.dead_parties) == 1
    assert w.bytes_match and w.digests_ok
    assert w.tape_nbytes < rep.ledger.nbytes and w.respawns == 0


def test_wire_modes_are_checked():
    with pytest.raises(ValueError, match="unknown wire mode"):
        WaveExecutor(ExecConfig(wire="carrier-pigeon", device="cpu"))
    with pytest.raises(ValueError, match="chaos_seed needs a real wire"):
        WaveExecutor(ExecConfig(chaos_seed=1, device="cpu"))
    with pytest.raises(NotImplementedError):
        WaveExecutor(ExecConfig(wire="local", mesh="host", device="cpu"))
    ex = WaveExecutor(ExecConfig(wire="socket", net="pod_dcn",
                                 device="cpu"))
    assert not ex.cfg.coalesce and ex.cfg.overlap


def test_phase_report_keys_equal_jax():
    kw = dict(n_batches=3, n_waves=2, wall_s=0.0)
    got = PhaseReport(ledger=Ledger(), per_batch=Ledger(),
                      sched=iosched.SchedConfig(), **kw)
    want = JPhaseReport(ledger=JLedger(), per_batch=JLedger(),
                        sched=j_iosched.SchedConfig(), **kw)
    assert got.as_dict().keys() == want.as_dict().keys()
    d, jd = got.as_dict(net=POD_DCN), want.as_dict(net=J_POD_DCN)
    assert d.keys() == jd.keys() and {"net", "net_makespan_s"} <= d.keys()
    assert d["net"] == "pod_dcn" and d["wire"] is None


@pytest.mark.wire
def test_socket_wire_bitwise_and_reconciled(setup, unwired):
    ref, _ = unwired["2pc"]
    got, rep = phase(setup, "2pc", wire="socket", net="pod_dcn")
    assert torch.equal(ref, got)
    w = rep.wire
    assert w.mode == "socket" and w.bytes_match and w.digests_ok
    assert w.wire_nbytes == rep.ledger.nbytes
    d = rep.as_dict(net=POD_DCN)
    assert d["wire"]["bytes_match"] and d["net"] == "pod_dcn"
