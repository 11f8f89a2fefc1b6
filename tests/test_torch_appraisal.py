"""The port's appraisal service (`repro_torch.serve`) against the JAX
package's `repro.serve`, piece by piece and without a JAX forward:

  1. DEALER — `phase_orders` of the port's probe equals JAX's orders, as
     (op, ring name, protocol, elems), on both rings; the pool's counters
     equal JAX's for the same stage and acquire calls (staged, clipped,
     topped up); an unstaged acquire tops up and counts a stall; a
     failure of the worker thread reaches the caller.
  2. CACHE — put/get bitwise in memory and across a persist_dir handoff
     (a disk hit), also from a JAX-written directory; the key separates
     fingerprint, ring and protocol.
  3. REPORT — phase_split, sequential_makespan, serve_makespan and
     throughput equal JAX's, as floats, on PhaseReports built from the
     same integer ledgers.
  4. GUARDS and the launcher — sessions reject wire/mesh modes; the
     `--appraise` launcher's report has JAX's keys, and it
     serves the other protocols (3pc places no dealer order, spdz2pc
     does).

The server's end-to-end parity is test_torch_appraisal32.py / 64.py.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import executor as j_exec
from repro.core import iosched as j_iosched
from repro.core.proxy import ProxySpec as JProxySpec
from repro.core.selection import PhaseRequest as JPhaseRequest
from repro.core.selection import SelectionConfig as JSelectionConfig
from repro.engine import cached_probe as j_cached_probe
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro import serve as j_serve
from repro_torch import serve
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import executor, iosched
from repro_torch.core.proxy import ProxySpec
from repro_torch.core.selection import PhaseRequest, SelectionConfig
from repro_torch.engine import cached_probe, cached_probe_info
from repro_torch.launch import serve as launch_serve
from repro_torch.mpc import protocols
from repro_torch.mpc.ring import RING32, RING64

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}


@pytest.fixture
def x64(monkeypatch):
    """RING64 on the JAX side under the installed jax (ROADMAP Queue 3)."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _probes(ring: str, spec=(1, 1, 2), batch=4):
    jr, pr = RINGS[ring]
    jcfg = dataclasses.replace(J_TINY, vocab_size=64)
    cfg = dataclasses.replace(TINY_TARGET, vocab_size=64)
    kw = dict(batch=batch, seq=8, classes=2, protocol="2pc", fused=True)
    return (j_cached_probe(jcfg, JProxySpec(*spec), ring=jr, **kw),
            cached_probe(cfg, ProxySpec(*spec), ring=pr, **kw))


def _orders(orders) -> list:
    return [(o.op, o.ring.name, o.protocol, o.elems) for o in orders]


def _wait_pooled(pool, elems: int) -> None:
    deadline = time.time() + 30
    while pool.stats()["pooled_elems"] < elems:
        assert time.time() < deadline, pool.stats()
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# 1. dealer pool
# ---------------------------------------------------------------------------

class TestDealer:
    @pytest.mark.parametrize("ring", ["ring32", "ring64"])
    @pytest.mark.parametrize("spec", [(1, 1, 2), (2, 2, 4)])
    def test_orders_equal_jax(self, x64, ring, spec):
        jpb, pb = _probes(ring, spec)
        jr, pr = RINGS[ring]
        got = _orders(serve.phase_orders(pb, 3, pr, "2pc"))
        assert got and got == _orders(j_serve.phase_orders(jpb, 3, jr,
                                                           "2pc"))
        assert {o[0]: o[3] for o in got} == \
            {op: numel * 3 for op, (numel, _) in pb.offline_by_op().items()}

    @pytest.mark.parametrize("capacity", [1 << 26, 2500])
    def test_counters_equal_jax(self, capacity):
        """Stage (clipped at `capacity` per key), let the worker fill the
        pool, acquire twice the staged demand (the second a top-up):
        every counter but the stall's seconds equals JAX's."""
        stats = []
        for mod, ring in ((j_serve, J_RING32), (serve, RING32)):
            orders = [mod.Order("offline.mul_triple", ring, "2pc", 3000),
                      mod.Order("offline.trunc_pair", ring, "2pc", 1000)]
            kw = {} if mod is j_serve else {"device": "cpu"}
            pool = mod.DealerPool(capacity_elems=capacity, seed=1, **kw)
            try:
                pool.stage(orders)
                _wait_pooled(pool, pool.stats()["staged_elems"])
                pool.acquire(orders)
                pool.acquire(orders[:1])
                st = pool.stats()
            finally:
                pool.close()
            stall_s = st.pop("dealer_stall_s")
            assert (stall_s > 0) == (st["stalls"] > 0)
            stats.append(st)
        assert stats[1] == stats[0]
        assert stats[1]["consumed_elems"] == 7000

    def test_staged_acquire_is_stall_free(self):
        orders = [serve.Order("offline.mul_triple", RING64, "2pc", 3000),
                  serve.Order("offline.trunc_pair", RING64, "2pc", 1000)]
        pool = serve.DealerPool(seed=1, device="cpu")
        try:
            pool.stage(orders)
            _wait_pooled(pool, 4000)
            pool.acquire(orders)
            st = pool.stats()
            assert st["dealer_stall_s"] == 0.0 and st["stalls"] == 0
            assert st["consumed_elems"] == 4000 == st["produced_elems"]
            assert st["produced_nbytes"] == 4000 * 8
        finally:
            pool.close()

    def test_unstaged_acquire_tops_up_and_bills_stall(self):
        pool = serve.DealerPool(seed=2, device="cpu")
        try:
            pool.acquire([serve.Order("offline.mul_triple", RING64, "2pc",
                                      2048)])
            st = pool.stats()
            assert st["consumed_elems"] == 2048 == st["staged_elems"]
            assert st["stalls"] == 1 and st["dealer_stall_s"] > 0.0
        finally:
            pool.close()

    def test_stats_after_close(self):
        pool = serve.DealerPool(seed=3, device="cpu")
        pool.stage([serve.Order("offline.trunc_pair", RING32, "2pc", 500)])
        pool.close()
        st = pool.stats()
        # close lets the worker finish its queue, then stops it
        assert not pool._thread.is_alive()
        assert st["produced_elems"] == st["pooled_elems"] == 500
        assert st["produced_nbytes"] == 500 * 4

    @pytest.mark.parametrize("ring", [RING32, RING64])
    def test_material_spans_the_ring(self, ring):
        gen = torch.Generator().manual_seed(0)
        buf = protocols.get("2pc").dealer_material(gen, "offline.mul_triple",
                                                   ring, 1 << 16)
        assert buf.dtype == ring.dtype and buf.shape == (1 << 16,)
        # uniform over the ring: both signs, both ends of the range
        lim = 1 << (ring.bits - 1)
        assert (buf < -lim // 2).any() and (buf > lim // 2).any()
        assert 0.45 < float((buf < 0).double().mean()) < 0.55

    def test_worker_failure_reaches_acquire_and_close(self, monkeypatch):
        def broken(*a, **kw):
            raise RuntimeError("out of memory")
        monkeypatch.setattr(protocols.BackendDefaults, "dealer_material",
                            broken)
        pool = serve.DealerPool(seed=4, device="cpu")
        t0 = time.time()
        with pytest.raises(serve.dealer.DealerError) as err:
            pool.acquire([serve.Order("offline.mul_triple", RING32, "2pc",
                                      10)], timeout_s=20.0)
        assert time.time() - t0 < 10.0          # not the timeout
        assert "out of memory" in str(err.value.__cause__)
        with pytest.raises(serve.dealer.DealerError):
            pool.close()


# ---------------------------------------------------------------------------
# 2. phase cache
# ---------------------------------------------------------------------------

def _req(mod, fingerprint="aa" * 8, phase=0, keep=8, batch=4):
    spec = (JProxySpec if mod is j_serve else ProxySpec)(1, 1, 2)
    req_cls = JPhaseRequest if mod is j_serve else PhaseRequest
    return req_cls(phase=phase, key=None, pp=None,
                   tokens=np.zeros((16, 8), np.int32), spec=spec,
                   keep=keep, batch=batch, fingerprint=fingerprint)


class TestPhaseCache:
    def test_memory_roundtrip_bitwise(self):
        c = serve.PhaseCache()
        key = serve.phase_key(_req(serve), RING64, "2pc")
        assert c.get(key) is None
        scores = np.arange(16, dtype=np.int64) * (1 << 40) - 7
        c.put(key, scores, None)
        got, rep = c.get(key)
        assert np.array_equal(got, scores) and rep is None
        assert c.stats() == {"hits": 1, "misses": 1, "disk_hits": 0,
                             "entries": 1}

    def test_key_separates_fingerprint_ring_protocol(self):
        base = serve.phase_key(_req(serve), RING64, "2pc")
        assert serve.phase_key(_req(serve, fingerprint="bb" * 8), RING64,
                               "2pc") != base
        assert serve.phase_key(_req(serve), RING32, "2pc") != base
        assert serve.phase_key(_req(serve), RING64, "spdz2pc") != base
        assert serve.phase_key(_req(serve, phase=1), RING64, "2pc") != base
        assert serve.phase_key(_req(serve), RING64, "2pc") == base
        # the JAX package's key for the same request: the same tuple
        assert base == j_serve.phase_key(_req(j_serve), J_RING64, "2pc")

    @pytest.mark.parametrize("ring", ["ring32", "ring64"])
    def test_persist_dir_survives_process_handoff(self, tmp_path, ring):
        _, pr = RINGS[ring]
        key = serve.phase_key(_req(serve), pr, "2pc")
        scores = (np.arange(8) - 3).astype(f"int{pr.bits}")
        serve.PhaseCache(persist_dir=str(tmp_path)).put(key, scores, None)
        c2 = serve.PhaseCache(persist_dir=str(tmp_path))   # fresh memory
        got, rep = c2.get(key)
        assert got.dtype == scores.dtype and np.array_equal(got, scores)
        assert rep is None and c2.stats()["disk_hits"] == 1

    def test_reads_a_jax_written_cache(self, tmp_path):
        scores = np.arange(8, dtype=np.int64) * (1 << 50) - 3
        j_serve.PhaseCache(persist_dir=str(tmp_path)).put(
            j_serve.phase_key(_req(j_serve), J_RING64, "2pc"), scores)
        c = serve.PhaseCache(persist_dir=str(tmp_path))
        got, _ = c.get(serve.phase_key(_req(serve), RING64, "2pc"))
        assert np.array_equal(got, scores) and c.stats()["disk_hits"] == 1


# ---------------------------------------------------------------------------
# 3. report
# ---------------------------------------------------------------------------

def _report_pairs(ring: str, n_batches=(5, 3, 2), sched_kw=None):
    """(JAX PhaseReports, port PhaseReports): each package's own probe
    ledgers (equal record for record), the same geometry."""
    jr, pr = RINGS[ring]
    jrep, prep = [], []
    for spec, nb in zip(((1, 1, 2), (2, 2, 4), (1, 2, 2)), n_batches):
        jpb, pb = _probes(ring, spec)
        for mod, pbl, r, out in ((j_exec, jpb, jr, jrep),
                                 (executor, pb, pr, prep)):
            sched = (j_iosched if mod is j_exec else iosched).SchedConfig(
                **(sched_kw or {}))
            out.append(mod.PhaseReport(
                ledger=pbl, per_batch=pbl, n_batches=nb,
                n_waves=-(-nb // sched.wave), wall_s=0.0, sched=sched,
                ring=r))
    return jrep, prep


class TestReport:
    @pytest.mark.parametrize("ring", ["ring32", "ring64"])
    @pytest.mark.parametrize("sched_kw", [{}, {"coalesce": False},
                                          {"overlap": False, "wave": 2}])
    def test_functions_equal_jax(self, x64, ring, sched_kw):
        from repro.mpc.comm import PROFILES as J_PROFILES
        from repro_torch.mpc.comm import PROFILES
        jrep, prep = _report_pairs(ring, sched_kw=sched_kw)
        for name in ("wan", "pod_dcn"):
            jnet, net = J_PROFILES[name], PROFILES[name]
            assert [serve.phase_split(r, net) for r in prep] == \
                [j_serve.phase_split(r, jnet) for r in jrep]
            assert serve.sequential_makespan(prep, net) == \
                j_serve.sequential_makespan(jrep, jnet)
            assert serve.serve_makespan(prep[:2], net) == \
                j_serve.serve_makespan(jrep[:2], jnet)
        # two sessions, the second served its first phase from the cache
        jsess = [SimpleNamespace(reports=jrep[:2]),
                 SimpleNamespace(reports=jrep[:1])]
        psess = [SimpleNamespace(reports=prep[:2]),
                 SimpleNamespace(reports=prep[:1])]
        for name in ("wan", "pod_dcn"):
            got = serve.throughput(psess, prep[:2], name)
            assert got == j_serve.throughput(jsess, jrep[:2], name)
            assert got["n_phases_total"] == 3
            assert got["serve_appraisals_per_hour"] > \
                got["sequential_appraisals_per_hour"]
        assert serve.serve_makespan([], PROFILES["wan"]) == 0.0


# ---------------------------------------------------------------------------
# 4. guards, the launcher, imports
# ---------------------------------------------------------------------------

def _session_spec(**exec_kw):
    from repro_torch.core import target
    from repro_torch.mpc import prng
    cfg = dataclasses.replace(TINY_TARGET, vocab_size=64)
    params = target.init_classifier(torch.Generator().manual_seed(0), cfg,
                                    2, device="cpu")
    pool = np.random.default_rng(0).integers(0, 64, (32, 8))
    sel = SelectionConfig(
        [ProxySpec(1, 1, 2, 1.0)], mode="mpc", score_batch=8,
        executor=executor.ExecConfig(wave=2, device="cpu", **exec_kw))
    return serve.SessionSpec(sid="x", key=prng.key(0), target_params=params,
                             arch_cfg=cfg, pool_tokens=pool, sel=sel,
                             n_classes=2, boot_labels_fn=lambda i: i % 2)


class TestGuards:
    @pytest.mark.parametrize("kw", [dict(wire="local"), dict(mesh="host")])
    def test_session_rejects_wire_and_mesh(self, kw):
        with pytest.raises(ValueError, match="wire='none', mesh='none'"):
            serve.AppraisalSession(_session_spec(**kw))

    def test_server_rejects_a_session_on_another_device(self):
        srv = serve.AppraisalServer(dealer=False, device="meta")
        with pytest.raises(ValueError, match="executes on 'cpu'"):
            srv.submit(_session_spec())

    def test_protocols_other_than_2pc_raise(self):
        """Once refused, now served: one small session (a pool of 48)
        under the dealer-free 3pc stages no dealer order, under spdz2pc
        it stages and consumes its MAC'd material; aby3trunc's probe
        orders nothing either. Every ledger agrees."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            reps = {name: launch_serve.appraise(
                n_sessions=1, n_pool=48, protocol=name, device="cpu",
                out_path=None) for name in ("3pc", "spdz2pc")}
        finally:
            torch.set_num_threads(threads)
        assert all(r["ledger_agrees"] is True for r in reps.values())
        assert reps["3pc"]["dealer"]["staged_elems"] == 0
        d = reps["spdz2pc"]["dealer"]
        assert d["staged_elems"] > 0
        assert d["consumed_elems"] == d["staged_elems"]
        cfg = dataclasses.replace(TINY_TARGET, vocab_size=64)
        pb = cached_probe(cfg, ProxySpec(1, 1, 2), batch=4, seq=8,
                          classes=2, ring=RING64, protocol="aby3trunc",
                          fused=True)
        assert pb.records and serve.phase_orders(pb, 3, RING64,
                                                 "aby3trunc") == []


def _jax_report_keys():
    """The JAX package's SERVE_report keys, from objects that run
    nothing: an empty server's report, a session's dict, a phase dict."""
    srv = j_serve.AppraisalServer()
    try:
        rep = srv.report()
    finally:
        srv.close()
    sel = JSelectionConfig([JProxySpec(1, 1, 2)], mode="mpc")
    sess = j_serve.AppraisalSession(j_serve.SessionSpec(
        sid="x", key=None, target_params=None, arch_cfg=None,
        pool_tokens=np.zeros((4, 4)), sel=sel, n_classes=2,
        boot_labels_fn=None))
    from repro.mpc.comm import Ledger
    phase = j_exec.PhaseReport(
        ledger=Ledger(), per_batch=Ledger(), n_batches=1, n_waves=1,
        wall_s=0.0, sched=j_iosched.SchedConfig(),
        device=j_exec.DeviceReport("none", 1, {})).as_dict()
    return rep, sess.as_dict(), phase


def test_launcher_report_has_jax_keys(tmp_path, capsys):
    """`python -m repro_torch.launch.serve --appraise` on the CPU at a
    small pool: it prints JAX's `[serve] N appraisals` line and writes
    the report; the report's keys, each block's, each session's and each
    phase dict's are JAX's; the twin's phases come from the cache and
    every ledger agrees."""
    out = tmp_path / "SERVE_report.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launch_serve.main(["--appraise", "--pool", "48", "--device", "cpu",
                           "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    line = capsys.readouterr().out
    assert line.startswith("[serve] 3 appraisals: ") and \
        "ledger_agrees=True" in line and str(out) in line
    rep = json.loads(out.read_text())
    jrep, jsess, jphase = _jax_report_keys()
    assert rep.keys() == jrep.keys()
    for block in ("throughput", "cache", "dealer"):
        assert rep[block].keys() == jrep[block].keys(), block
    assert len(rep["sessions"]) == 3
    for s in rep["sessions"]:
        assert s.keys() == jsess.keys()
        for ph in s["phases"]:
            assert ph.keys() == jphase.keys()
    assert rep["ledger_agrees"] is True
    assert rep["cache"]["hits"] + rep["cache"]["coalesced_waits"] > 0
    assert rep["sessions"][1]["cached_phases"] == [0, 1]
    assert rep["dealer"]["dealer_stall_s"] == 0.0
    assert rep["throughput"]["n_phases_executed"] == 4
    assert cached_probe_info().hits > 0


def test_serve_and_checkpoint_import_with_jax_blocked():
    """serve/ and checkpoint/ (and what they reach) import where jax and
    the JAX package cannot, and their sources name neither."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.serve, repro_torch.checkpoint\n"
            "import repro_torch.launch.serve\n"
            "assert sys.modules['jax'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    for d in ("serve", "checkpoint"):
        for f in (src / "repro_torch" / d).glob("*.py"):
            text = f.read_text()
            assert "import jax" not in text and "from repro." not in text \
                and "import repro." not in text, f
