"""Deterministic sharded data pipeline for LM training — the port of
repro/data/pipeline.py, a copy (numpy only, so every batch is bitwise the
JAX package's for the same (seed, step, host)).

Synthetic-corpus based (no corpus to download), but with the structure of a
production loader: per-host deterministic sharding by (step, host_id),
stateless batch addressing (resume = replay from step), background
prefetch, and pack-to-seq_len. `DataPipeline.state()` round-trips through
the checkpointer so restarts are exactly-once.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


def synth_lm_batch(seed: int, step: int, host: int, n_hosts: int,
                   batch: int, seq: int, vocab: int):
    """Deterministic (step, host)-addressed LM batch. Markov-ish synthetic
    token stream so the loss actually decreases during examples."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 64 + host)
    b_local = batch // n_hosts
    base = rng.integers(0, vocab, size=(b_local, 1), dtype=np.int32)
    steps = rng.integers(1, 7, size=(b_local, seq), dtype=np.int32)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    tokens = toks.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class DataPipeline:
    """Background-prefetching deterministic loader."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int,
                 host: int = 0, n_hosts: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab
        self.host, self.n_hosts = host, n_hosts
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = synth_lm_batch(self.seed, step, self.host, self.n_hosts,
                               self.batch, self.seq, self.vocab)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, b = self._q.get()
        self._step = step + 1
        return b

    def state(self) -> PipelineState:
        return PipelineState(self.seed, self._step)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
