"""Appraisal-as-a-service: multi-tenant private selection — the port of
`repro.serve`.

The data-market endgame (paper §1): model owners appraise a continuous
stream of candidate datasets under MPC. This package turns the one-shot
`run_selection` pipeline into a long-running service —

  session.py   one appraisal as a schedulable state machine over
               `core.selection.selection_plan`
  server.py    queue + round-robin wave interleaver (continuous
               batching across sessions) + admission-time dealer staging
  dealer.py    background thread pre-generating offline material into a
               bounded per-(op, ring) pool, drawn on the executors'
               device; `dealer_stall_s` is the pipelining metric
  cache.py     cross-session phase cache keyed on the run fingerprint +
               phase geometry + ring + protocol
  report.py    sustained appraisals/hour vs the N-sequential baseline,
               priced from the same iosched stream totals

Invariant: scheduling moves flights, never values — every session's
scores are bitwise identical to its standalone run.
"""
from repro_torch.serve.cache import PhaseCache, phase_key
from repro_torch.serve.dealer import DealerPool, Order, phase_orders
from repro_torch.serve.report import (phase_split, sequential_makespan,
                                      serve_makespan, throughput)
from repro_torch.serve.server import AppraisalServer
from repro_torch.serve.session import AppraisalSession, SessionSpec

__all__ = [
    "AppraisalServer", "AppraisalSession", "SessionSpec", "DealerPool",
    "Order", "phase_orders", "PhaseCache", "phase_key", "phase_split",
    "sequential_makespan", "serve_makespan", "throughput",
]
