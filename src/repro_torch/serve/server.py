"""AppraisalServer — continuous-batching multi-tenant private selection;
the port of repro/serve/server.py.

The server holds a queue of (data-owner, model-owner) sessions, each a
full `selection_plan`, and interleaves their MPC waves round-robin: a
dispatched wave is left in flight (the PhaseRun double buffer) while
the scheduler moves to the next session, so one session's wire time
hides behind another's local compute — the intra-phase double buffer
extended to inter-session continuous batching. Admission pre-stages
each session's dealer demand (sized from the same TraceEngine probes
the executor reconciles against) so the background dealer produces
offline material during the session's clear-side proxy generation;
fingerprint-identical phases are served from the cross-session cache
without executing at all.

Scheduling moves WHEN flights happen, never what they carry: every
session's keys and record order are exactly `run_selection`'s, so
scores, survivors, and appraisals are bitwise identical to standalone
runs.

Every session's executor runs on `device` (the dealer draws its
material there). Each executed phase's `DeviceReport` counts its own
session's ring-kernel launches (PhaseRun counts around its dispatches);
its `device_makespan_s` spans first dispatch to last ready on the one
stream the sessions share, so under interleaving it includes the other
sessions' waves.
"""
from __future__ import annotations

import time
from collections import deque

import torch

from repro_torch.core import selection as sel_mod
from repro_torch.engine import cached_probe, cached_probe_info
from repro_torch.serve import report as report_mod
from repro_torch.serve.cache import PhaseCache, phase_key
from repro_torch.serve.dealer import DealerPool, phase_orders
from repro_torch.serve.session import AppraisalSession, SessionSpec


class AppraisalServer:
    """Queue + interleaving scheduler + dealer pipeline + phase cache."""

    def __init__(self, *, max_active: int = 4, dealer: bool = True,
                 dealer_capacity: int = 1 << 26, dealer_seed: int = 0,
                 cache_persist_dir: str | None = None, device="cuda"):
        self.max_active = max_active
        self.device = torch.device(device)
        self.cache = PhaseCache(cache_persist_dir)
        self.pool = (DealerPool(capacity_elems=dealer_capacity,
                                seed=dealer_seed, device=self.device)
                     if dealer else None)
        self.queue: deque[AppraisalSession] = deque()
        self.completed: list[AppraisalSession] = []
        self.executed_reports = []        # phases actually run (not cached)
        self._inflight: dict[tuple, AppraisalSession] = {}
        self.coalesced_waits = 0
        self._t0 = None

    # ---- admission ------------------------------------------------------
    def submit(self, spec: SessionSpec) -> AppraisalSession:
        if torch.device(spec.sel.executor.device) != self.device:
            raise ValueError(
                f"session {spec.sid!r} executes on "
                f"{spec.sel.executor.device!r}, the server on "
                f"{str(self.device)!r}")
        sess = AppraisalSession(spec)
        if self.pool is not None:
            self.pool.stage(self._session_orders(spec))
        self.queue.append(sess)
        return sess

    def _session_orders(self, spec: SessionSpec):
        """Dealer demand of every phase the session will run, from the
        same memoized TraceEngine probes the executor later reconciles
        its ledgers against (so staging is exact, not a heuristic)."""
        sel = spec.sel
        ex = sel.executor
        n = int(spec.pool_tokens.shape[0])
        seq = int(spec.pool_tokens.shape[1])
        budget = int(round(sel.budget_frac * n))
        n_boot = max(8, int(round(sel.boot_frac * n)))
        surviving = n - n_boot
        keeps = sel_mod._phase_keep(surviving, budget - n_boot, sel.phases)
        orders = []
        cur = surviving
        for ph, keep in zip(sel.phases, keeps):
            batch = min(sel.score_batch, cur)
            n_batches = -(-cur // batch)
            per_batch = cached_probe(
                spec.arch_cfg, ph, batch=batch, seq=seq,
                classes=spec.n_classes, ring=ex.ring, protocol=ex.protocol,
                fused=ex.fuse, variant=sel.variant)
            orders.extend(phase_orders(per_batch, n_batches, ex.ring,
                                       ex.protocol))
            cur = keep
        return orders

    # ---- scheduling -----------------------------------------------------
    def _step(self, sess: AppraisalSession) -> None:
        """One scheduling quantum: advance the plan, resolve the cache,
        or dispatch exactly one wave (leaving it in flight for the next
        session's quantum to overlap with)."""
        if sess.scoring:
            if sess.waves_left > 0:
                if self.pool is not None:
                    ex = sess.spec.sel.executor
                    self.pool.acquire(phase_orders(
                        sess.run.per_batch, sess.run.lanes(sess.next_wave),
                        ex.ring, ex.protocol))
                sess.dispatch_next()
            else:
                ent, rep = sess.finish_phase()
                self.executed_reports.append(rep)
                self.cache.put(sess._cache_key, ent.sh.cpu().numpy(), rep)
                self._inflight.pop(sess._cache_key, None)
            return
        if sess.request is not None:
            ex = sess.spec.sel.executor
            key = phase_key(sess.request, ex.ring, ex.protocol)
            if self._inflight.get(key) is not None:
                # request coalescing: an identical phase is executing in
                # another session right now — wait for its scores to
                # land in the cache instead of duplicating the work
                self.coalesced_waits += 1
                return
            hit = self.cache.get(key)
            if hit is not None:
                scores, rep = hit
                sess.feed_scores(scores, rep)
            else:
                sess._cache_key = key
                self._inflight[key] = sess
                sess.begin_phase()
            return
        sess.advance_plan()               # clear-side work / completion

    def run(self) -> dict:
        """Drain the queue; returns the SERVE_report dict."""
        self._t0 = time.time()
        active: list[AppraisalSession] = []
        while self.queue or active:
            while self.queue and len(active) < self.max_active:
                active.append(self.queue.popleft())
            for sess in list(active):
                self._step(sess)
                if sess.done:
                    active.remove(sess)
                    self.completed.append(sess)
        return self.report()

    # ---- reporting ------------------------------------------------------
    def report(self, net: str = "wan") -> dict:
        wall_s = (time.time() - self._t0) if self._t0 else 0.0
        out = {
            "sessions": [s.as_dict() for s in self.completed],
            "throughput": report_mod.throughput(self.completed,
                                                self.executed_reports, net),
            "cache": {**self.cache.stats(),
                      "coalesced_waits": self.coalesced_waits},
            "probe_cache": cached_probe_info(),
            "ledger_agrees": all(s.ledger_agrees() for s in self.completed),
            "wall_s": wall_s,
        }
        out["dealer"] = (self.pool.stats() if self.pool is not None
                         else {"dealer_stall_s": 0.0, "staged_elems": 0,
                               "produced_elems": 0, "consumed_elems": 0,
                               "pooled_elems": 0, "stalls": 0,
                               "produced_nbytes": 0})
        return out

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
