"""Cross-session phase cache — fingerprinted score reuse; the port of
repro/serve/cache.py.

`selection_plan` stamps every PhaseRequest with the run fingerprint
(`selection._run_fingerprint`: pool contents, bootstrap draw, target
weights, full config). Two queued sessions appraising the same model on
the same pool therefore present IDENTICAL (fingerprint, phase) keys —
the cache returns the first session's score shares and the second skips
execution entirely. Because QuickSelect/appraisal run inside the plan
on whatever scores come back, a cache hit is bitwise-indistinguishable
from a re-execution.

The key extends the fingerprint with the phase geometry, ring, and
protocol (already folded into the fingerprint, but explicit here so a
cache entry is self-describing and the hit condition is auditable).

Entries optionally persist to disk through `repro_torch.checkpoint`
(manifest-verified npz + atomic COMMIT): a restarted server warm-starts
from the previous lifetime's scores. Disk-restored entries carry scores
only — the original PhaseReport (ledger, device stamps) lives and dies
with the process that executed it. Scores are host numpy arrays of the
ring's integer dtype.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint


def phase_key(req, ring, protocol: str) -> tuple:
    """Cache key for one PhaseRequest under an executor substrate."""
    s = req.spec
    return (req.fingerprint, req.phase,
            (s.n_layers, s.n_heads, s.mlp_dim),
            int(req.tokens.shape[0]), int(req.keep), int(req.batch),
            ring.name, protocol)


class PhaseCache:
    """(fingerprint, phase, geometry, ring, protocol) -> score shares."""

    def __init__(self, persist_dir: str | None = None):
        self._mem: dict[tuple, tuple[np.ndarray, object]] = {}
        self.persist_dir = persist_dir
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    def _slot(self, key: tuple) -> str:
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        return os.path.join(self.persist_dir, f"phase_cache_{digest}")

    def get(self, key: tuple):
        """(scores, report_or_None) on hit, None on miss — counters
        updated either way."""
        ent = self._mem.get(key)
        if ent is None and self.persist_dir:
            tree, step = restore_checkpoint(self._slot(key),
                                            {"ent": np.empty(0)})
            if step is not None:
                ent = (np.asarray(tree["ent"]), None)
                self._mem[key] = ent
                self.disk_hits += 1
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        return ent

    def put(self, key: tuple, scores: np.ndarray, report=None) -> None:
        self._mem[key] = (scores, report)
        if self.persist_dir:
            save_checkpoint(self._slot(key), 0, {"ent": scores})

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "disk_hits": self.disk_hits, "entries": len(self._mem)}
