"""Pipelined offline dealer — pre-generates correlated randomness; the
port of repro/serve/dealer.py.

The additive-2pc and spdz2pc backends consume dealer material (Beaver
triples, sacrifice triples, truncation pairs, MAC keys) whose bytes land
on the ledger's OFFLINE channel (the dealer-free 3pc and aby3trunc
place no order): priced separately from the online wire precisely
because a crypto provider can stream them AHEAD of the phase. Standalone runs leave that
pipelining implicit; the appraisal server makes it real. At session
admission the server sizes each phase's demand from its TraceEngine
probe (`Ledger.offline_by_op` x the wave fan-out) and `stage()`s
production orders; a worker thread then synthesizes the material
(`ProtocolBackend.dealer_material`) into a bounded per-(op, ring) pool
WHILE the session's clear-side proxy generation runs. Online waves
`acquire()` their allocation just before dispatch — if the pool already
holds it (the steady state), acquisition is instant; only an actual
wait accrues `dealer_stall_s`, the report's headline pipelining metric.

Material is pool-plumbing, not execution input: online values stay
key-derived from the session's threefry stream, so scores are bitwise
identical to standalone runs no matter how the dealer is scheduled.
The pool holds pre-staged BYTES of the right shape — the offline
channel realized — and `capacity_elems` bounds how far ahead the
dealer may run per (op, ring) key.

Where the port departs from the JAX package: the material is drawn on
the executors' device (`device`), from a `torch.Generator` seeded with
`seed`, on the worker thread's own CUDA stream, in chunks of
`chunk_elems` (default 2^28 elements, so one BERT-width wave's order is
a handful of launches; the JAX package draws 2^16-element chunks with
numpy on the host, which at that width would cost tens of seconds and
gigabytes of host memory a wave). The bytes are uniform over the ring
but are not numpy's stream. A chunk counts as produced once its draw
has completed on the device. Orders, staging, clipping and every
counter in `stats()` are the JAX package's for the same sequence of
calls. A failure on the worker thread is re-raised to the caller at the
next `stage`, `acquire` or `close`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import torch

from repro_torch.mpc import protocols
from repro_torch.mpc.ring import RingSpec


@dataclasses.dataclass(frozen=True)
class Order:
    """One production order: `elems` ring elements of offline material
    for `op` under `ring`, synthesized by `protocol`'s backend. The
    shift dimension is implicit: the only truncation pairs a dealer
    serves are the ring's canonical frac_bits shift."""
    op: str
    ring: RingSpec
    protocol: str
    elems: int

    @property
    def key(self) -> tuple[str, str]:
        return (self.op, self.ring.name)


def phase_orders(per_batch, n_batches: int, ring: RingSpec,
                 protocol: str) -> list[Order]:
    """Dealer orders for one phase: the probe's per-batch offline
    footprint (`Ledger.offline_by_op`) times the batch fan-out."""
    return [Order(op=op, ring=ring, protocol=protocol,
                  elems=numel * n_batches)
            for op, (numel, _) in sorted(per_batch.offline_by_op().items())
            if numel > 0]


class DealerError(RuntimeError):
    """The dealer's worker thread failed; raised from `stage`, `acquire`
    or `close` with the worker's exception as its cause."""


class DealerPool:
    """Bounded per-(op, ring) pool of pre-generated dealer material,
    filled by a background worker thread, drained by online waves."""

    def __init__(self, capacity_elems: int = 1 << 26, seed: int = 0,
                 chunk_elems: int = 1 << 28, device="cuda"):
        self.capacity_elems = int(capacity_elems)
        self.chunk_elems = int(chunk_elems)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cv = threading.Condition()
        self._orders: deque[Order] = deque()
        self._avail: dict[tuple, list[torch.Tensor]] = {}
        self._avail_elems: dict[tuple, int] = {}
        self._stop = False
        self._error: Exception | None = None
        self.staged_elems = 0
        self.produced_elems = 0
        self.produced_nbytes = 0
        self.consumed_elems = 0
        self.dealer_stall_s = 0.0
        self.stalls = 0
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="dealer")
        self._thread.start()

    def _raise_failed(self) -> None:
        """Re-raise the worker's failure (call holding `_cv`)."""
        if self._error is not None:
            raise DealerError("the dealer's worker thread failed") \
                from self._error

    # ---- producer side --------------------------------------------------
    def stage(self, orders: list[Order]) -> None:
        """Enqueue production orders (admission-time pre-staging). The
        pool bound applies per key: an order beyond `capacity_elems`
        ahead of consumption is clipped and re-ordered on demand by the
        acquire path (bounded memory beats a silent unbounded queue)."""
        with self._cv:
            self._raise_failed()
            for o in orders:
                have = (self._avail_elems.get(o.key, 0)
                        + sum(q.elems for q in self._orders
                              if q.key == o.key))
                room = max(0, self.capacity_elems - have)
                clipped = dataclasses.replace(o, elems=min(o.elems, room))
                if clipped.elems > 0:
                    self._orders.append(clipped)
                    self.staged_elems += clipped.elems
            self._cv.notify_all()

    def _draw(self, backend, order: Order, n: int) -> torch.Tensor:
        """One chunk, drawn and completed on the worker's stream."""
        if self._stream is None:
            return backend.dealer_material(self._gen, order.op, order.ring,
                                           n)
        with torch.cuda.stream(self._stream):
            buf = backend.dealer_material(self._gen, order.op, order.ring, n)
        self._stream.synchronize()
        return buf

    def _work(self) -> None:
        try:
            self._produce()
        except Exception as e:   # the consumer re-raises it (_raise_failed)
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def _produce(self) -> None:
        while True:
            with self._cv:
                while not self._orders and not self._stop:
                    self._cv.wait()
                if self._stop and not self._orders:
                    return
                order = self._orders.popleft()
            backend = protocols.get(order.protocol)
            left = order.elems
            while left > 0:
                n = min(left, self.chunk_elems)
                buf = self._draw(backend, order, n)
                left -= n
                with self._cv:
                    self._avail.setdefault(order.key, []).append(buf)
                    self._avail_elems[order.key] = \
                        self._avail_elems.get(order.key, 0) + n
                    self.produced_elems += n
                    self.produced_nbytes += buf.numel() * buf.element_size()
                    self._cv.notify_all()

    # ---- consumer side --------------------------------------------------
    def acquire(self, orders: list[Order], timeout_s: float = 60.0) -> None:
        """Consume one wave's offline allocation. Instant when the pool
        holds it; otherwise a top-up order covers the shortfall and the
        wait — only the wait — lands in `dealer_stall_s`."""
        for o in orders:
            if o.elems <= 0:
                continue
            with self._cv:
                self._raise_failed()
                if self._avail_elems.get(o.key, 0) < o.elems:
                    # demand the pool bound clipped (or a mis-sized
                    # probe missed): order the shortfall and stall
                    short = o.elems - self._avail_elems.get(o.key, 0)
                    self._orders.append(dataclasses.replace(o, elems=short))
                    self.staged_elems += short
                    self._cv.notify_all()
                    self.stalls += 1
                    t0 = time.perf_counter()
                    deadline = t0 + timeout_s
                    while self._avail_elems.get(o.key, 0) < o.elems:
                        self._raise_failed()
                        if not self._cv.wait(timeout=deadline
                                             - time.perf_counter()):
                            raise TimeoutError(
                                f"dealer pool starved for {o.key}")
                    self.dealer_stall_s += time.perf_counter() - t0
                left = o.elems
                bufs = self._avail[o.key]
                while left > 0:
                    head = bufs[0]
                    if len(head) <= left:
                        bufs.pop(0)
                        left -= len(head)
                    else:
                        bufs[0] = head[left:]
                        left = 0
                self._avail_elems[o.key] -= o.elems
                self.consumed_elems += o.elems

    def close(self) -> None:
        """Stop the worker once its queued orders are drawn; re-raises a
        failure of the worker."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with self._cv:
            self._raise_failed()

    def stats(self) -> dict:
        with self._cv:
            return {
                "staged_elems": self.staged_elems,
                "produced_elems": self.produced_elems,
                "produced_nbytes": self.produced_nbytes,
                "consumed_elems": self.consumed_elems,
                "pooled_elems": sum(self._avail_elems.values()),
                "dealer_stall_s": self.dealer_stall_s,
                "stalls": self.stalls,
            }
