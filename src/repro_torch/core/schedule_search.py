"""Offline grid search over selection schedules (paper §4.2) — the port
of repro/core/schedule_search.py.

"The model owner schedules the selection by setting {<l_i, w_i, d_i>}
for N phases... SelectFormer determines the schedule via offline grid
search." This module implements that search against the EXECUTED cost
stream: each candidate phase is priced by a TraceEngine probe of the
one engine-generic forward (`engine/forward.py`) on meta tensors — the identical op
stream the wave executor realizes, round-compressed by the flight
batcher when `fused` (defaulting to the executor's own `fuse` default,
so pricing tracks what deployments actually run) — then scheduled by
the IO makespan model. Searched schedules therefore
price what will actually fly, not a paper-geometry approximation
(`costs.proxy_model_cost`, which fuses QKV and ignores ring truncation,
remains for the analytic figures).

Capacity score is a cheap monotone proxy for expected selection quality:
sum over phases of log(l*w*d) weighted by the fraction of the pool the
phase actually scores — matching the paper's observation that capacity
in LATER phases (which decide the final set) matters most.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

from repro_torch.configs.base import ArchConfig
from repro_torch.core import iosched
from repro_torch.core.proxy import ProxySpec
from repro_torch.mpc.comm import Ledger, NetProfile, WAN
from repro_torch.mpc.ring import RING64, RingSpec


@dataclasses.dataclass(frozen=True)
class ScoredSchedule:
    phases: tuple[ProxySpec, ...]
    delay_s: float
    capacity: float


@functools.lru_cache(maxsize=512)
def _phase_probe(n_layers: int, n_heads: int, mlp_dim: int, *,
                 d_model: int, heads: int, classes: int, seq: int,
                 batch: int, ring: RingSpec, fused: bool,
                 protocol: str = "2pc") -> Ledger:
    """Per-batch ledger of one phase proxy, probed from the executed
    forward (weight-free: abstract_shares on meta tensors). Delegates to
    the engine-level `cached_probe` memo, so the search shares probe
    results with the executor (same geometry key)."""
    from repro_torch.engine import cached_probe

    dh = d_model // heads
    cfg = ArchConfig(name="sched-probe", family="dense",
                     n_layers=max(n_layers, 1), d_model=d_model,
                     n_heads=heads, n_kv_heads=heads, d_head=dh,
                     d_ff=0, vocab_size=2)
    spec = ProxySpec(n_layers, min(n_heads, heads), mlp_dim)
    return cached_probe(cfg, spec, batch=batch, seq=seq, classes=classes,
                        ring=ring, protocol=protocol, fused=fused)


def schedule_delay(phases, n_pool: int, budget: int, *, d_model: int = 768,
                   heads: int = 12, classes: int = 2, seq: int = 512,
                   batch: int = 4, net: NetProfile = WAN,
                   sched: iosched.SchedConfig | None = None,
                   ring: RingSpec = RING64,
                   protocol: str = "2pc",
                   fused: bool | None = None) -> float:
    """`fused=None` prices whatever the executor would run by default
    (ExecConfig.fuse) — the search must rank schedules by the stream the
    deployment realizes, and follows that default if it flips."""
    if fused is None:
        from repro_torch.core.executor import ExecConfig
        fused = ExecConfig().fuse
    sched = sched or iosched.SchedConfig()
    remaining = n_pool
    total = 0.0
    for i, ph in enumerate(phases):
        led = _phase_probe(ph.n_layers, ph.n_heads, ph.mlp_dim,
                           d_model=d_model, heads=heads, classes=classes,
                           seq=seq, batch=batch, ring=ring, fused=fused,
                           protocol=protocol)
        total += iosched.makespan(led, -(-remaining // batch), net, sched)
        remaining = budget if i == len(phases) - 1 else \
            max(budget, int(remaining * ph.selectivity))
    return total


def capacity_score(phases, n_pool: int, budget: int) -> float:
    import math
    remaining = n_pool
    score = 0.0
    for i, ph in enumerate(phases):
        frac = remaining / n_pool
        # final-phase capacity decides the purchased set: weight by the
        # inverse of how much pool it sees (later = more selective)
        weight = 1.0 + (i + 1) / len(phases)
        score += weight * math.log(ph.n_layers * ph.n_heads * ph.mlp_dim) \
            * (0.5 + 0.5 * frac)
        remaining = budget if i == len(phases) - 1 else \
            max(budget, int(remaining * ph.selectivity))
    return score


def grid_search(n_pool: int, budget_frac: float = 0.2, *, heads: int = 12,
                max_phases: int = 3, net: NetProfile = WAN
                ) -> list[ScoredSchedule]:
    """Pareto frontier over (delay, capacity) for 1..max_phases."""
    budget = int(budget_frac * n_pool)
    dims = (2, 4, 8, 16)
    layer_opts = (1, 3)
    sel_opts = (0.3, 0.5)
    cands: list[tuple[ProxySpec, ...]] = []
    for d in dims:
        for nl in layer_opts:
            cands.append((ProxySpec(nl, heads if nl > 1 else 1, d, 1.0),))
    if max_phases >= 2:
        for d1, d2 in itertools.product((2, 4), dims):
            if d2 < d1:
                continue
            for s1 in sel_opts:
                cands.append((ProxySpec(1, 1, d1, s1),
                              ProxySpec(3, heads, d2, 1.0)))
    if max_phases >= 3:
        for d2 in (4, 8):
            cands.append((ProxySpec(1, 1, 2, 0.5),
                          ProxySpec(1, heads, d2, 0.5),
                          ProxySpec(3, heads, 16, 1.0)))
    scored = [ScoredSchedule(p, schedule_delay(p, n_pool, budget,
                                               heads=heads, net=net),
                             capacity_score(p, n_pool, budget))
              for p in cands]
    # Pareto: keep schedules not dominated in (lower delay, higher capacity)
    pareto = [s for s in scored
              if not any(o.delay_s <= s.delay_s and o.capacity > s.capacity
                         or o.delay_s < s.delay_s and o.capacity >= s.capacity
                         for o in scored)]
    return sorted(pareto, key=lambda s: s.delay_s)
