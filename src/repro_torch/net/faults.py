"""Deterministic fault injection for the party wire — the port of
repro/net/faults.py (`from_tape` draws from the same seeded numpy
generator in the same order, so a seed and a tape give the JAX
package's plan, JSON for JSON).

A `FaultPlan` is a seeded, fully reproducible schedule of failures
against a specific tape replay:

  drop     lose DATA frame k on directed link (src, dst) — the frame is
           counted (goodput is priced at first transmission) but never
           delivered; the reliability layer must recover it.
  spike    stall the sender for `extra_s` before frame k on a link — a
           latency spike, not a loss.
  reset    hard connection reset while sending frame k on a link: the
           frame is lost AND the link goes down (socket backend: the
           TCP pair is closed so both ends see it; local backend: the
           link's undelivered queue is purged). Recovery is reconnect +
           go-back-N retransmit.
  crash    party p dies at the top of flight f (before sending any of
           it): `InjectedCrash` in a thread worker, a hard `os._exit`
           in a process worker. Recovery is supervisor respawn + cursor
           resume — or degraded 2-of-3 completion when the party died
           at a phase boundary.
  slow     party p stalls `slow_s` at every flight — a straggler, for
           heartbeat/escalation paths.

Placement is derived from the tape's own structure (flight count,
per-link frame counts) by `FaultPlan.from_tape(seed, tape)` via a
seeded PRNG — the same seed and tape always produce the identical plan
(the determinism contract CI tests), and a plan can be serialized to
JSON (`--chaos-plan`) and replayed elsewhere.

`ChaosTransport` applies a plan identically over `LocalTransport` and
`SocketTransport` (and composes under `ReliableTransport`): it sits on
the SENDER side of every link, keyed by per-link DATA frame index.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np

from repro_torch.net import transport as tp


class InjectedCrash(BaseException):
    """A chaos-scheduled party death. Derives from BaseException so no
    protocol-level `except Exception` can accidentally survive it —
    only the worker entry point is allowed to catch it."""


@dataclasses.dataclass
class FaultPlan:
    """Seeded fault schedule. All fields are pickle-plain (spawned
    party processes receive the plan through multiprocessing args)."""
    seed: int
    drops: dict = dataclasses.field(default_factory=dict)
    #   (src, dst) -> tuple of per-link DATA frame indices to lose
    spikes: dict = dataclasses.field(default_factory=dict)
    #   (src, dst) -> {frame_index: extra_seconds}
    resets: dict = dataclasses.field(default_factory=dict)
    #   (src, dst) -> tuple of frame indices that reset the connection
    crash: tuple | None = None          # (party, flight) or None
    slow: dict = dataclasses.field(default_factory=dict)
    #   party -> stall seconds per flight

    @property
    def n_faults(self) -> int:
        return (sum(len(v) for v in self.drops.values())
                + sum(len(v) for v in self.spikes.values())
                + sum(len(v) for v in self.resets.values())
                + (1 if self.crash else 0) + len(self.slow))

    def without_crash(self) -> "FaultPlan":
        """The plan a respawned incarnation runs under — every link
        fault stays armed, but the party does not die twice."""
        return dataclasses.replace(self, crash=None)

    def crash_party(self) -> int | None:
        return self.crash[0] if self.crash else None

    # -- construction ---------------------------------------------------
    @classmethod
    def from_tape(cls, seed: int, tape, *, n_drops: int = 2,
                  n_spikes: int = 1, n_resets: int = 1,
                  spike_s: float = 0.05, crash: bool = True,
                  crash_at_boundary: bool = False,
                  slow_party: int | None = None,
                  slow_s: float = 0.0) -> "FaultPlan":
        """Derive a deterministic plan from the tape's structure. The
        PRNG is seeded and every choice is over sorted, tape-derived
        populations — same (seed, tape) in, same plan out, bit for bit.

        Faults are placed on the busiest links (most frames) so short
        smokes still exercise every recovery path; the crash lands
        mid-phase (flight in [1, n_flights-1)) unless
        `crash_at_boundary` pins it to flight 0 — the degraded-mode
        trigger."""
        rng = np.random.default_rng(seed)
        frames = tape.link_frames()
        links = sorted(frames, key=lambda k: (-frames[k], k))
        if not links:
            return cls(seed=seed)

        def pick(link, n_avoid_first=1):
            # frame 0 on a link often carries a SYNC-adjacent first
            # exchange; any index is legal, this just spreads placement
            hi = frames[link]
            return int(rng.integers(0, hi)) if hi else 0

        drops: dict = {}
        for i in range(min(n_drops, len(links))):
            link = links[i % len(links)]
            drops.setdefault(link, set()).add(pick(link))
        spikes: dict = {}
        for i in range(min(n_spikes, len(links))):
            link = links[(i + 1) % len(links)]
            spikes.setdefault(link, {})[pick(link)] = float(spike_s)
        resets: dict = {}
        for i in range(min(n_resets, len(links))):
            link = links[(i + 2) % len(links)]
            k = pick(link)
            # a reset and a drop on the same frame would double-fire
            if k in drops.get(link, ()):
                k = (k + 1) % max(1, frames[link])
            resets.setdefault(link, set()).add(k)

        crash_spec = None
        if crash and tape.n_parties > 1 and len(tape.flights) > 2:
            party = int(rng.integers(1, tape.n_parties))
            if crash_at_boundary:
                flight = 0
            else:
                flight = int(rng.integers(1, len(tape.flights) - 1))
            crash_spec = (party, flight)

        slow = {}
        if slow_party is not None and slow_s > 0:
            slow[slow_party] = float(slow_s)

        return cls(seed=seed,
                   drops={k: tuple(sorted(v)) for k, v in drops.items()},
                   spikes=spikes,
                   resets={k: tuple(sorted(v)) for k, v in resets.items()},
                   crash=crash_spec, slow=slow)

    # -- (de)serialization: --chaos-plan files --------------------------
    def to_json(self) -> str:
        def k(link):
            return f"{link[0]}->{link[1]}"
        return json.dumps({
            "seed": self.seed,
            "drops": {k(link): list(v) for link, v in self.drops.items()},
            "spikes": {k(link): {str(i): s for i, s in v.items()}
                       for link, v in self.spikes.items()},
            "resets": {k(link): list(v) for link, v in self.resets.items()},
            "crash": list(self.crash) if self.crash else None,
            "slow": {str(p): s for p, s in self.slow.items()},
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)

        def link(s):
            a, b = s.split("->")
            return (int(a), int(b))
        return cls(
            seed=int(raw.get("seed", 0)),
            drops={link(s): tuple(v) for s, v in raw.get("drops", {}).items()},
            spikes={link(s): {int(i): float(x) for i, x in v.items()}
                    for s, v in raw.get("spikes", {}).items()},
            resets={link(s): tuple(v) for s, v in raw.get("resets", {}).items()},
            crash=tuple(raw["crash"]) if raw.get("crash") else None,
            slow={int(p): float(s) for p, s in raw.get("slow", {}).items()})


class ChaosTransport:
    """Apply a FaultPlan at the sender side of a base Transport.

    Sits UNDER `ReliableTransport` and over either backend: reliability
    sees faulted links exactly as it would see a faulty network. Frame
    indexing counts every DATA transmission on a directed link
    (retransmissions included), so placement is a pure function of the
    plan — and dropped frames are still byte-counted (goodput is priced
    at first transmission; recovery traffic lands in the RETRANS
    channel by the sequence-number watermark underneath).
    """

    def __init__(self, base, plan: FaultPlan, *, sleep=time.sleep):
        self.base = base
        self.plan = plan
        self.n_parties = base.n_parties
        self._sleep = sleep
        self._idx: dict = {}
        self._lock = threading.Lock()
        self.dropped = 0
        self.resets_fired = 0
        self.spiked = 0

    def _next_idx(self, link) -> int:
        with self._lock:
            k = self._idx.get(link, 0)
            self._idx[link] = k + 1
            return k

    def send(self, src: int, dst: int, data, kind: int = tp.DATA,
             seq=None) -> None:
        if kind != tp.DATA:
            # forward seq: SYNC frames are sequenced by the reliability
            # layer too — stripping it here would let a retransmitted
            # barrier frame bypass receiver dedup
            return self.base.send(src, dst, data, kind, seq)
        link = (src, dst)
        k = self._next_idx(link)
        extra = self.plan.spikes.get(link, {}).get(k)
        if extra:
            self.spiked += 1
            self._sleep(extra)
        if k in self.plan.resets.get(link, ()):
            # the frame is lost in the reset: count it (first-tx goodput
            # / retrans by watermark), then kill the link
            self.resets_fired += 1
            self.base._count(src, dst, len(data), kind, seq)
            if hasattr(self.base, "inject_reset"):
                self.base.inject_reset(dst)       # socket: both ends die
            else:
                self.base.purge(src, dst, tp.DATA)  # local: window lost
            return
        if k in self.plan.drops.get(link, ()):
            self.dropped += 1
            self.base._count(src, dst, len(data), kind, seq)
            return
        return self.base.send(src, dst, data, kind, seq)

    # -- passthrough ----------------------------------------------------
    def recv_seq(self, dst, src, kind=tp.DATA, timeout=None):
        return self.base.recv_seq(dst, src, kind, timeout)

    def recv(self, dst, src, kind=tp.DATA, timeout=None):
        return self.base.recv(dst, src, kind, timeout)

    def try_recv(self, dst, src, kind=tp.DATA):
        return self.base.try_recv(dst, src, kind)

    def link_down(self, peer):
        return self.base.link_down(peer)

    def reconnect(self, peer, timeout: float = 10.0):
        return self.base.reconnect(peer, timeout)

    def purge(self, src, dst, kind=tp.DATA):
        return self.base.purge(src, dst, kind)

    def restore_accounting(self, data_bytes, tx_counted):
        return self.base.restore_accounting(data_bytes, tx_counted)

    def _count(self, src, dst, n, kind, seq=None):
        return self.base._count(src, dst, n, kind, seq)

    @property
    def data_bytes(self):
        return self.base.data_bytes

    @property
    def retrans_bytes(self):
        return self.base.retrans_bytes

    @property
    def ack_bytes(self):
        return self.base.ack_bytes

    @property
    def n_frames(self):
        return self.base.n_frames

    @property
    def total_data_bytes(self):
        return self.base.total_data_bytes

    def close(self):
        self.base.close()
