"""The progressive sieve's clear side — the port of the clear pieces of
repro/core/selection.py: the paper's two-phase schedule, the per-phase
survivor counts, and one clear sieve phase (score the survivors with a
float proxy, keep the top `keep` by entropy, report the appraisal).

The clear phase runs the same proxy forward as the private sieve
(`engine/forward.proxy_entropy`) on a `ClearEngine`; on the card its
MLP_sm attention runs on the `mlp_softmax_attn` kernel. The full
pipeline (`selection_plan` / `run_selection`) needs the clear-side
training, and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.proxy import ProxySpec
from repro_torch.engine.base import FULL_VARIANT
from repro_torch.engine.forward import proxy_entropy


def two_phase_default(seq_len_heads: int = 12) -> list[ProxySpec]:
    """The paper's main schedule: <1 layer, 1 head, d=2> -> <3, all, 16>."""
    return [ProxySpec(1, 1, 2, selectivity=0.5),
            ProxySpec(3, seq_len_heads, 16, selectivity=1.0)]


def _phase_keep(n_pool: int, budget: int, phases: list[ProxySpec]) -> list[int]:
    """Survivor counts per phase ending exactly at the budget."""
    keeps = []
    cur = n_pool
    for i, ph in enumerate(phases):
        if i == len(phases) - 1:
            keeps.append(budget)
        else:
            cur = max(budget, int(round(cur * ph.selectivity)))
            keeps.append(cur)
    return keeps


def _score_clear(engine, pp, cfg, tokens, spec,
                 variant=FULL_VARIANT, batch: int = 256) -> np.ndarray:
    """Entropy scores of `tokens` (N, S) under a clear proxy, `batch` rows
    at a time on the proxy's device, as float32 numpy."""
    dev = pp["embed"].device
    out = []
    for i in range(0, tokens.shape[0], batch):
        t = torch.as_tensor(tokens[i:i + batch], device=dev)
        out.append(proxy_entropy(engine, pp, cfg, t, spec, variant)
                   .cpu().numpy())
    return np.concatenate(out)


def clear_phase(engine, pp, cfg, pool_tokens, surviving, spec, keep: int,
                variant=FULL_VARIANT, batch: int = 256):
    """One clear sieve phase over the pool rows `surviving`: returns the
    kept rows (sorted pool indices), the appraisal (mean entropy of the
    kept) and every survivor's score."""
    ents = _score_clear(engine, pp, cfg, pool_tokens[surviving], spec,
                        variant, batch)
    top_local = np.argsort(ents)[-keep:]
    appraisal = float(np.mean(ents[top_local]))
    return np.sort(surviving[top_local]), appraisal, ents
