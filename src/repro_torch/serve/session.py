"""One appraisal session: a (data-owner, model-owner) selection run
decomposed into schedulable units — the port of repro/serve/session.py.

The session wraps `core.selection.selection_plan` — the full 3-stage
pipeline as a generator — and exposes the server-facing state machine:

  advance_plan()   run the plan to its next PhaseRequest (all clear-side
                   work — bootstrap, proxy generation, QuickSelect of
                   the previous phase — happens inside this call)
  begin_phase()    open a stepwise PhaseRun for the pending request
  dispatch_next()  execute one wave (leaves it in flight, double-buffered)
  finish_phase()   drain + seal the PhaseRun, feed scores back to the plan
  feed_scores()    feed CACHED scores back instead (skip execution)

Numerics are the plan's: the session never touches keys, QuickSelect,
or appraisal, so scores/survivors are bitwise identical to a standalone
`run_selection` regardless of how the server interleaves dispatches.
Every wave's flights land in the session's OWN ledger (PhaseRun's
`outer`), keeping per-session accounting exact under interleaving.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import ExecConfig, PhaseReport, PhaseRun
from repro_torch.core.selection import SelectionConfig, selection_plan
from repro_torch.mpc import comm
from repro_torch.mpc.sharing import Share


@dataclasses.dataclass
class SessionSpec:
    """Everything one appraisal request carries at admission."""
    sid: str
    key: torch.Tensor                # the run's root prng key
    target_params: dict
    arch_cfg: ArchConfig
    pool_tokens: np.ndarray
    sel: SelectionConfig
    n_classes: int
    boot_labels_fn: object


class AppraisalSession:
    """Server-side state of one queued appraisal."""

    def __init__(self, spec: SessionSpec):
        ex = spec.sel.executor
        if ex.wire != "none" or ex.mesh != "none":
            # the interleaver owns the schedule; wire capture and device
            # meshes assume they own the process — standalone runs keep
            # those modes
            raise ValueError("appraisal sessions run wire='none', "
                             "mesh='none' (got wire=%r, mesh=%r)"
                             % (ex.wire, ex.mesh))
        self.spec = spec
        self.sid = spec.sid
        self.ledger = comm.Ledger()          # all online flights, per session
        self.plan = selection_plan(
            spec.key, spec.target_params, spec.arch_cfg, spec.pool_tokens,
            spec.sel, n_classes=spec.n_classes,
            boot_labels_fn=spec.boot_labels_fn)
        self._send = None
        self.request = None                  # pending PhaseRequest
        self.run: PhaseRun | None = None
        self.next_wave = 0
        self.result = None                   # SelectionResult when done
        self.reports: list[PhaseReport] = []
        self.cached_phases: list[int] = []
        self._cache_key = None               # server's key for the open phase
        self.admitted_s = time.time()
        self.done_s: float | None = None

    # ---- plan driving ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def scoring(self) -> bool:
        return self.run is not None

    @property
    def waves_left(self) -> int:
        return 0 if self.run is None else self.run.n_waves - self.next_wave

    def advance_plan(self) -> None:
        """Step the generator to its next PhaseRequest (or completion).
        The clear-side compute between MPC phases runs here — exactly
        the work the dealer thread pipelines its production behind."""
        try:
            self.request = self.plan.send(self._send)
        except StopIteration as done:
            self.result = done.value
            self.request = None
            self.done_s = time.time()
        self._send = None

    # ---- phase execution ------------------------------------------------
    def phase_cfg(self) -> ExecConfig:
        return dataclasses.replace(self.spec.sel.executor,
                                   batch=self.request.batch)

    def begin_phase(self) -> PhaseRun:
        req = self.request
        self.run = PhaseRun(self.phase_cfg(), req.key, req.pp,
                            self.spec.arch_cfg, req.tokens, req.spec,
                            self.spec.sel.variant, outer=self.ledger)
        self.next_wave = 0
        return self.run

    def dispatch_next(self) -> None:
        self.run.dispatch(self.next_wave)
        self.next_wave += 1

    def finish_phase(self) -> tuple[Share, PhaseReport]:
        self.run.drain()
        ent, rep = self.run.finish()
        self.reports.append(rep)
        self.run = None
        self._send = (ent, [rep])
        self.request = None
        return ent, rep

    def feed_scores(self, scores: np.ndarray, report=None) -> None:
        """Cache hit: hand the plan a copy of previously-computed score
        shares on the session's executor device (the ring's integer
        dtype carries over as it is). QuickSelect/appraisal still run
        inside the plan, so downstream results match a real execution
        bit for bit."""
        ex = self.spec.sel.executor
        ent = Share(torch.tensor(scores, device=ex.device), ex.ring,
                    ex.protocol)
        self.cached_phases.append(self.request.phase)
        if report is not None:
            self.reports.append(report)
        self._send = (ent, [report] if report is not None else [])
        self.request = None

    # ---- reporting ------------------------------------------------------
    def ledger_agrees(self) -> bool:
        return all(r.agrees() for r in self.reports)

    def as_dict(self) -> dict:
        """SERVE_report entry: the same per-phase dict shape as
        SELECT_report's `executed` block (PhaseReport.as_dict)."""
        return {
            "sid": self.sid,
            "phases": [r.as_dict() for r in self.reports],
            "ledger_agrees": (all(r.agrees() for r in self.reports)
                              if self.reports else None),
            "resumed_phases": (self.result.resumed_phases
                               if self.result else 0),
            "cached_phases": list(self.cached_phases),
            "appraisal_entropy": (self.result.appraisal_entropy
                                  if self.result else None),
            "n_selected": (int(len(self.result.selected))
                           if self.result else None),
            "wall_s": ((self.done_s or time.time()) - self.admitted_s),
        }
