"""The port's `AppraisalServer` end to end on the CPU, on RING32
(`Appraisal` is shared with test_torch_appraisal64.py for RING64), at
tests/test_serve.py's geometry: the TINY target (vocab 64), seq 8, a
pool of 32 (8 bootstrap rows, a budget of 16), one phase <1,1,2>
keeping 8, score batches of 8 in waves of 2, serial (the JAX executor's
coalesced run costs minutes of XLA compiles on the CPU; scores do not
depend on the schedule).

Three sessions: "a", its twin "b" (the same target and pool) and "c"
(another target over another pool). The targets are built by the JAX
package from a seed and carried across; pools and labels come from
numpy.

  * The service's invariant: every session's phase scores, survivors
    and appraisal are bitwise those of the port's standalone
    `run_selection` of its spec, with the dealer on or off; the twin is
    served from the cache or by waiting on the in-flight phase, never
    executed; each session's ledger holds exactly its own flights and
    each executed phase counts its own ring-kernel calls.
  * Against the JAX package's `AppraisalServer` on the same specs, with
    both packages' training replaced by the same JAX-built proxy
    (test_torch_selection_clear.inject, test only; float training is
    not bitwise between the frameworks): the same three fields bitwise,
    and the report's integer fields equal (phases, cache hits and
    misses, coalesced waits, the dealer's counters, ledger agreement).

The dealer's counters are compared once its worker has drawn the
admission-time orders (the test waits for that before `run`), so that
no acquire races the worker.
"""
import dataclasses
import functools
import time

import numpy as np
import jax
import pytest
import torch

from repro import serve as j_serve
from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import proxy as j_proxy
from repro.core import selection as j_sel
from repro.core import target as j_target
from repro.core.executor import ExecConfig as JExecConfig
from repro.data.tasks import make_classification_task
from repro.engine import MPCEngine as JMPCEngine
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro_torch import serve
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import selection, tree
from repro_torch.core.executor import ExecConfig
from repro_torch.core.proxy import ProxySpec
from repro_torch.engine import MPCEngine
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RING32, RING64
from test_torch_selection_clear import inject

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
SEQ, POOL, VOCAB, CLASSES = 8, 32, 64, 2
SPEC = (1, 1, 2, 1.0)
EXEC = dict(wave=2, coalesce=False)
SESSIONS = (("a", 3), ("b", 3), ("c", 5))     # b is a's twin
J_CFG = dataclasses.replace(J_TINY, vocab_size=VOCAB)
CFG = dataclasses.replace(TINY_TARGET, vocab_size=VOCAB)
STEPS = dict(budget_frac=0.5, boot_frac=0.25, exvivo_steps=2,
             invivo_steps=1, finetune_steps=1, score_batch=8,
             checkpoint_dir=None)


@functools.lru_cache(maxsize=None)
def _inputs(seed: int):
    """(pool tokens, labels, JAX target params, the port's copy)."""
    task = make_classification_task(seed, n_pool=POOL, n_test=16, seq=SEQ,
                                    vocab=VOCAB, n_classes=CLASSES)
    jp = j_target.init_classifier(jax.random.key(seed), J_CFG, CLASSES)
    return (task.pool_tokens, task.pool_labels, jp,
            tree.to_device(jax.tree.map(np.asarray, jp), "cpu"))


def port_sel(ring: str) -> selection.SelectionConfig:
    pr = RINGS[ring][1]
    return selection.SelectionConfig(
        [ProxySpec(*SPEC)], engine=MPCEngine(ring=pr), **STEPS,
        executor=ExecConfig(ring=pr, device="cpu", **EXEC))


def port_spec(sid: str, seed: int, ring: str) -> serve.SessionSpec:
    tok, lab, _, pp = _inputs(seed)
    return serve.SessionSpec(sid=sid, key=prng.key(seed), target_params=pp,
                             arch_cfg=CFG, pool_tokens=tok,
                             sel=port_sel(ring), n_classes=CLASSES,
                             boot_labels_fn=lambda i: lab[i])


def jax_spec(sid: str, seed: int, ring: str) -> j_serve.SessionSpec:
    tok, lab, jp, _ = _inputs(seed)
    jr = RINGS[ring][0]
    sel = j_sel.SelectionConfig(
        [j_proxy.ProxySpec(*SPEC)], engine=JMPCEngine(ring=jr), **STEPS,
        executor=JExecConfig(ring=jr, **EXEC))
    return j_serve.SessionSpec(sid=sid, key=jax.random.key(seed),
                               target_params=jp, arch_cfg=J_CFG,
                               pool_tokens=tok, sel=sel, n_classes=CLASSES,
                               boot_labels_fn=lambda i: lab[i])


def run_server(srv, specs):
    """Submit, let the dealer draw the admission-time orders, drain."""
    sessions = [srv.submit(s) for s in specs]
    try:
        if srv.pool is not None:
            deadline = time.time() + 30
            while (srv.pool.stats()["pooled_elems"]
                   < srv.pool.stats()["staged_elems"]):
                assert time.time() < deadline, srv.pool.stats()
                time.sleep(0.005)
        rep = srv.run()
    finally:
        srv.close()
    return sessions, rep


def serve_port(ring: str, dealer: bool = True):
    return run_server(serve.AppraisalServer(dealer=dealer, device="cpu"),
                      [port_spec(sid, seed, ring) for sid, seed in SESSIONS])


def assert_same_result(got, want):
    assert len(got.phase_scores) == len(want.phase_scores) == 1
    for x, y in zip(got.phase_scores, want.phase_scores):
        np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(got.selected, want.selected)
    assert got.appraisal_entropy == want.appraisal_entropy


INT_FIELDS = {"throughput": ("n_sessions", "n_phases_total",
                             "n_phases_executed"),
              "cache": ("hits", "misses", "disk_hits", "entries",
                        "coalesced_waits"),
              "dealer": ("staged_elems", "produced_elems", "produced_nbytes",
                         "consumed_elems", "pooled_elems", "stalls")}


class Appraisal:
    RING = "ring32"

    @pytest.fixture(scope="class", autouse=True)
    def one_thread(self):
        """The port's runs on one torch thread: the suite's parallel
        workers would otherwise spin torch's pool against each other."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)

    @pytest.fixture(scope="class")
    def served(self, request):
        """The port's server (dealer on) and each distinct spec's
        standalone run, with the port's own training."""
        ring = request.cls.RING
        sessions, rep = serve_port(ring)
        standalone = {}
        for sid, seed in SESSIONS:
            if seed not in standalone:
                s = port_spec(sid, seed, ring)
                standalone[seed] = selection.run_selection(
                    s.key, s.target_params, s.arch_cfg, s.pool_tokens,
                    s.sel, n_classes=s.n_classes,
                    boot_labels_fn=s.boot_labels_fn)
        return sessions, rep, standalone

    @pytest.fixture
    def x64(self, monkeypatch):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)

    def test_scores_bitwise_standalone(self, served):
        sessions, _, standalone = served
        for s, (_, seed) in zip(sessions, SESSIONS):
            assert s.done
            assert_same_result(s.result, standalone[seed])
        assert not np.array_equal(sessions[0].result.phase_scores[0],
                                  sessions[2].result.phase_scores[0])

    def test_twin_served_without_execution(self, served):
        (a, b, c), rep, _ = served
        t = rep["throughput"]
        assert (t["n_phases_executed"], t["n_phases_total"]) == (2, 3)
        assert b.cached_phases == [0] and b.reports == a.reports
        assert a.cached_phases == c.cached_phases == []
        cache = rep["cache"]
        assert cache["hits"] + cache["coalesced_waits"] > 0
        assert cache["misses"] == 2 and cache["entries"] == 2

    def test_ledgers_and_launches_are_per_session(self, served):
        (a, b, c), rep, standalone = served
        assert rep["ledger_agrees"] is True
        assert all(s.ledger_agrees() for s in (a, b, c))
        for s in (a, c):
            own = [r for rep_ in s.reports for r in rep_.ledger.records]
            assert s.ledger.records == own and own
        assert b.ledger.records == []
        # each phase counts its own ring-kernel calls (the CPU's plain
        # versions), as its standalone run does, though a's and c's
        # waves interleave
        for s, seed in ((a, 3), (c, 5)):
            got, want = s.reports[0].device, \
                standalone[seed].exec_reports[0].device
            calls = (got.combine_ref, got.matmul_ref, got.combine_kernel,
                     got.matmul_kernel)
            assert calls == (want.combine_ref, want.matmul_ref,
                             want.combine_kernel, want.matmul_kernel)
            assert got.combine_ref + got.matmul_ref > 0

    def test_throughput_model_and_dealer(self, served):
        (a, b, c), rep, _ = served
        t = rep["throughput"]
        assert t["serve_appraisals_per_hour"] > \
            t["sequential_appraisals_per_hour"]
        d = rep["dealer"]
        assert d["dealer_stall_s"] == 0.0 and d["stalls"] == 0
        assert d["produced_elems"] == d["staged_elems"] > 0
        # a's and c's waves took their material; b's stays pooled
        assert d["consumed_elems"] + d["pooled_elems"] == \
            d["produced_elems"]
        assert 2 * d["pooled_elems"] == d["consumed_elems"]
        assert d["produced_nbytes"] == \
            d["produced_elems"] * RINGS[self.RING][1].elem_bytes

    def test_dealer_off_scores_bitwise(self, served):
        sessions, rep, _ = served
        off, rep_off = serve_port(self.RING, dealer=False)
        for s, t in zip(off, sessions):
            assert_same_result(s.result, t.result)
        assert rep_off["dealer"]["produced_elems"] == 0
        assert rep_off["throughput"] == rep["throughput"]

    def test_matches_jax_server(self, monkeypatch, x64):
        """Both packages' training replaced by the same JAX-built proxy:
        each session's result bitwise JAX's, the report's integer fields
        equal."""
        jpp = j_proxy.random_proxy(jax.random.key(21), J_CFG,
                                   j_proxy.ProxySpec(*SPEC[:3]), SEQ,
                                   CLASSES)
        inject(monkeypatch, {SPEC[:3]: jpp})
        jsess, jrep = run_server(
            j_serve.AppraisalServer(),
            [jax_spec(sid, seed, self.RING) for sid, seed in SESSIONS])
        psess, prep = serve_port(self.RING)
        for p, j in zip(psess, jsess):
            assert p.cached_phases == j.cached_phases
            assert_same_result(p.result, j.result)
        for block, fields in INT_FIELDS.items():
            assert {f: prep[block][f] for f in fields} == \
                {f: jrep[block][f] for f in fields}, block
        assert prep["ledger_agrees"] is jrep["ledger_agrees"] is True
        assert [s.ledger_agrees() for s in psess] == \
            [s.ledger_agrees() for s in jsess]
        for p, j in zip(prep["sessions"], jrep["sessions"]):
            assert [(x["lat_rounds"], x["bw_rounds"], x["nbytes"],
                     x["offline_nbytes"]) for x in p["phases"]] == \
                [(x["lat_rounds"], x["bw_rounds"], x["nbytes"],
                  x["offline_nbytes"]) for x in j["phases"]]


class TestRing32(Appraisal):
    RING = "ring32"
