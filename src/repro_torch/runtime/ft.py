"""Fault-tolerance runtime: heartbeats, stragglers, retries, elasticity —
the port of repro/runtime/ft.py, host-side Python with numpy.

Design intent at 1000+ nodes:
  * every host runs a HeartbeatMonitor; a missed deadline marks the host
    suspect and triggers the launcher's restart-from-checkpoint path
    (checkpoint/ckpt.py provides the atomic resume point; selection
    phases additionally checkpoint survivor sets at phase boundaries).
  * data-loading and MPC batch execution run under StragglerMitigator:
    if a task exceeds p95 * slack, a backup task is dispatched and the
    first finisher wins (classic backup-requests).
  * ElasticPlan computes the host-level transfer spec when the mesh is
    re-factorized (shrink on failure / grow on recovery) so re-sharding
    moves only the diff, not a full re-init.

Everything is process-local and deterministic; the interfaces match
what a multi-host launcher drives. The module imports neither torch nor
anything of the port that does: spawned wire parties (net/runtime.py)
import it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = {h: clock() for h in range(n_hosts)}
        self._lock = threading.Lock()

    def beat(self, host: int) -> None:
        with self._lock:
            self._last[host] = self._clock()

    def suspects(self) -> list[int]:
        now = self._clock()
        with self._lock:
            return [h for h, t in self._last.items()
                    if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.suspects()


class StragglerMitigator:
    """Deadline-based backup dispatch; tracks a running p95 of task
    times. `clock` is injectable so tests can drive deterministic task
    durations without sleeping."""

    def __init__(self, slack: float = 2.0, window: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.slack = slack
        self._times: list[float] = []
        self._window = window
        self._clock = clock
        self.backups_fired = 0

    def deadline(self) -> float:
        if len(self._times) < 8:
            return float("inf")
        return float(np.percentile(self._times[-self._window:], 95)) * self.slack

    def run(self, task: Callable[[], object],
            backup: Callable[[], object] | None = None):
        t0 = self._clock()
        deadline = self.deadline()
        result = task()
        dt = self._clock() - t0
        if dt > deadline and backup is not None:
            self.backups_fired += 1
            result = backup()          # first-finisher-wins (serial sim)
        self._times.append(dt)
        return result


class TransportHeartbeat:
    """Heartbeats riding a party transport as control frames.

    Duck-typed over `net.transport.Transport` (anything with
    `send(src, dst, data, kind)` / `try_recv(dst, src, kind)`) so this
    module never imports the net package. `kind` defaults to the BEAT
    frame kind (net.transport.BEAT == 1).

    Non-zero parties `emit()` a zero-byte BEAT to party 0 between
    flights; party 0 `drain()`s its beat queues non-blockingly into a
    HeartbeatMonitor — a silent party ages out of the monitor exactly
    like a dead host would, while healthy parties cost one control frame
    per beat interval on the already-open links.
    """

    def __init__(self, transport, party: int, n_parties: int,
                 monitor: HeartbeatMonitor | None = None, kind: int = 1):
        self.transport = transport
        self.party = party
        self.n_parties = n_parties
        self.monitor = monitor              # party 0 owns one; others None
        self.kind = kind
        self.beats_seen = 0

    def emit(self) -> None:
        if self.party != 0:
            self.transport.send(self.party, 0, b"", kind=self.kind)

    def drain(self) -> int:
        """Party 0: absorb all waiting beats; returns how many."""
        if self.monitor is None:
            return 0
        self.monitor.beat(0)                # party 0 vouches for itself
        got = 0
        for src in range(1, self.n_parties):
            while self.transport.try_recv(0, src, kind=self.kind) is not None:
                self.monitor.beat(src)
                got += 1
        self.beats_seen += got
        return got


def retry(fn: Callable[[], object], *, attempts: int = 3,
          backoff_s: float = 0.1, retriable=(IOError, OSError),
          sleep: Callable[[float], None] = time.sleep,
          clock: Callable[[], float] = time.monotonic,
          deadline_s: float | None = None,
          max_backoff_s: float = 5.0):
    """Call `fn` until it returns, retrying `retriable` failures with
    exponential backoff. `sleep`/`clock` are injectable so transports can
    service control traffic during the wait and tests can run without
    wall-clock time; `deadline_s` bounds the TOTAL elapsed time (checked
    before each backoff sleep) — the socket dial loop and the reliable
    recv resend loop both run on this one primitive."""
    last = None
    t0 = clock()
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:           # noqa: PERF203
            last = e
            if i == attempts - 1:        # no pointless sleep after the end
                break
            wait = min(backoff_s * (2 ** i), max_backoff_s)
            if deadline_s is not None and clock() - t0 + wait > deadline_s:
                break
            sleep(wait)
    raise last


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    moves: list[tuple[int, int]]         # (src_host, dst_host) transfers
    reshard_fraction: float              # fraction of bytes that move
    bytes_moved: int = 0                 # reshard_fraction * total bytes


def plan_remesh(old_shape: tuple[int, ...], new_shape: tuple[int, ...],
                bytes_per_host: int = 1) -> ElasticPlan:
    """Host-level transfer plan for a mesh re-factorization.

    Model: parameters are range-sharded over the flattened mesh; host h of
    N owns slice [h/N, (h+1)/N). On re-factorization to M hosts, dst d
    needs bytes overlapping [d/M, (d+1)/M) — moves are the off-diagonal
    overlaps (contiguous-range reshard, the standard scalable scheme).
    `bytes_per_host` sizes the old shards, so `bytes_moved` is the wire
    cost of the transfer in bytes (the launcher budgets recovery time
    against it).
    """
    n = int(np.prod(old_shape))
    m = int(np.prod(new_shape))
    moves: list[tuple[int, int]] = []
    moved = 0.0
    for d in range(m):
        lo, hi = d / m, (d + 1) / m
        for s in range(n):
            slo, shi = s / n, (s + 1) / n
            ov = max(0.0, min(hi, shi) - max(lo, slo))
            if ov > 1e-12 and s != d:
                moves.append((s, d))
                moved += ov
    return ElasticPlan(old_shape, new_shape, moves, moved,
                       int(round(moved * n * bytes_per_host)))
