"""Flight fusion — round compression of the executed MPC stream (§4.4).

The eager op stream pays one wire flight per opening: every Beaver
`(eps, delta)` open is a round, and on the RING32 ring every
fixed-point truncation adds a dealer round on top. But most of those
flights carry messages that are *locally computable before the flight
departs*: Beaver mask differences (`x - a`) and dealer-masked values
(`z + r`) are functions of dealer randomness plus values the party
already holds, with any dependence on previously-opened values entering
only through PUBLIC reconstructions both parties can apply after the
fact. Every opening in such a group can therefore ride ONE simultaneous
message flight — rounds are paid once per group, bytes are unchanged.

This module is the batcher that realizes that compression in the
accounting layer while leaving the share arithmetic bit-for-bit
untouched:

  flight_scope()     installs a FlightBatcher: every bandwidth-bound
                     1-round opening recorded through `comm.record`
                     (Beaver opens, dealer `trunc_open`s, reveals) is
                     DEFERRED instead of landing in the Ledger.
  fused_group(lbl)   an explicit independence annotation: flushes the
                     ambient segment, then flushes the group's own
                     openings as one named flight (`fused.<lbl>`).
  barriers           latency-bound flights (secure comparisons) need
                     real interaction, so a "lat" record flushes the
                     pending segment before it lands — fusion never
                     reorders a comparison past the opens it consumes.
  lat_scope(lbl)     coalesces *independent* comparison batches (the
                     per-wave QuickSelect partitions) into one "lat"
                     flight: rounds paid once, bytes summed.

Legality: a group may share a flight iff no message in it depends on
another message of the same flight being received first. The argument
is per protocol backend (mpc/protocols/): additive-2PC chains of
mul/mul_public/trunc qualify under the deferred-reconstruction
convention above (parties exchange only mask components and apply the
public adjustments locally); replicated-3PC resharing messages are
locally computable before their flight departs, so independent groups
(qkv, ln_stats) batch identically — the batcher itself is
scheme-agnostic because every backend marks its deferrable flights
tag="bw". Comparisons never qualify — hence the barrier. Dealer
(tag="offline") records are not flights at all: they pass through to
the ledger's offline channel without flushing anything.

Everything here is accounting: the batcher intercepts `comm.record`
calls, so the PRNG key stream, the dealer triples, and every share an
op produces are identical to the eager path (asserted bitwise across
all variant sets in tests/test_fusion.py). `compress_events` replays an
analytic record stream through the same batcher, which is how
`costs.proxy_exec_cost(fused=True)` mirrors the fused stream
record-for-record without a second implementation of flush semantics.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

from repro_torch.mpc import comm


# ---------------------------------------------------------------------------
# pending state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PendingOpen:
    """One deferred opening: the record it would have landed eagerly.

    `msgs` are the opening's captured wire messages (comm.WireMsg) when
    a WireTape is ambient — serialized at ABSORB time, while the share
    tensors are alive, and re-emitted on the fused flight so a fused
    group becomes ONE framed message per link carrying every deferred
    opening's bytes back to back."""
    op: str
    nbytes: int
    numel: int
    flops: int
    rounds: int = 1
    tag: str = "bw"
    msgs: tuple = ()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

class FlightBatcher:
    """Collects deferrable openings and flushes them as fused flights.

    Installed into the ambient comm state by `flight_scope`;
    `comm.record` offers every record via `absorb()` before it lands in
    the Ledger.
    """

    def __init__(self) -> None:
        self.pending: list[PendingOpen] = []
        self.pending_lat: list[PendingOpen] = []
        self._label: str | None = None
        self._lat_label: str | None = None
        self._in_lat_group = False
        self._suspended = False
        self.n_flights = 0            # fused bw flights emitted
        self.n_lat_flights = 0
        self.n_deferred = 0           # openings absorbed

    # -- interception ----------------------------------------------------
    def absorb(self, op: str, rounds: int, nbytes: int, numel: int,
               flops: int, tag: str, payload=None) -> bool:
        """Offer one record. True -> deferred (caller must not ledger it);
        False -> caller records eagerly (after any barrier flush).

        When a WireTape is ambient the deferred opening's payload is
        serialized HERE (the tensors are only guaranteed alive at absorb
        time) and carried on the PendingOpen until the flush emits it."""
        if self._suspended:
            return False
        if tag == "offline":
            # dealer bytes never ride the online wire: not a flight, not
            # a barrier — land in the ledger's offline channel as-is
            return False
        tape = comm.get_wire_tape()
        msgs = comm.normalize_payload(payload, nbytes, rounds,
                                      tape.n_parties) if tape is not None \
            else ()
        if tag == "lat":
            if self._in_lat_group:
                self.pending_lat.append(
                    PendingOpen(op, nbytes, numel, flops, rounds, tag,
                                msgs))
                self.n_deferred += 1
                return True
            # comparisons are real interaction: barrier, then pass through
            self.flush()
            return False
        if tag == "bw" and rounds <= 1:
            # rounds == 0: a piggyback message (3pc trunc re-replication)
            # that rides whatever flight the segment flushes as
            self.pending.append(PendingOpen(op, nbytes, numel, flops,
                                            rounds, "bw", msgs))
            self.n_deferred += 1
            return True
        self.flush()                  # unknown multi-round op: be safe
        return False

    # -- flushing --------------------------------------------------------
    def _emit(self, op: str, rounds: int, batch: list[PendingOpen],
              tag: str) -> None:
        nbytes = sum(p.nbytes for p in batch)
        numel = sum(p.numel for p in batch)
        flops = sum(p.flops for p in batch)
        # fused flight payload: every deferred opening's messages, in
        # deferral order — the PartyRuntime frames them as ONE message
        # per link (only meaningful when a WireTape was ambient at
        # absorb time; empty tuples merge to an empty payload -> None)
        msgs = [m for p in batch for m in p.msgs]
        self._suspended = True        # don't re-absorb our own flush
        try:
            comm.record(op, rounds=rounds, nbytes=nbytes, numel=numel,
                        flops=flops, tag=tag, payload=msgs or None)
        finally:
            self._suspended = False

    def flush(self, label: str | None = None) -> None:
        """Emit the pending segment as ONE flight (no-op when empty).
        A segment of only piggyback records (rounds 0) flushes at 0
        rounds — fusing must never create a round eager mode didn't pay."""
        if self.pending:
            batch, self.pending = self.pending, []
            self._emit(f"fused.{label or self._label or 'flight'}",
                       max(p.rounds for p in batch), batch, "bw")
            self.n_flights += 1

    def flush_lat(self, label: str | None = None) -> None:
        """Emit coalesced comparison batches as ONE latency flight —
        rounds are the protocol's (paid once), bytes are summed."""
        if self.pending_lat:
            batch, self.pending_lat = self.pending_lat, []
            rounds = max(p.rounds for p in batch)
            self._emit(f"fused.{label or self._lat_label or 'cmp'}",
                       rounds, batch, "lat")
            self.n_lat_flights += 1

    # -- group scopes ----------------------------------------------------
    @contextlib.contextmanager
    def fused_group(self, label: str) -> Iterator[None]:
        """One independent op group = one flight: close the ambient
        segment on entry, flush the group's own openings on exit."""
        self.flush()
        prev = self._label
        self._label = label
        try:
            yield
        finally:
            self.flush(label)
            self._label = prev

    @contextlib.contextmanager
    def lat_group(self, label: str) -> Iterator[None]:
        prev, prev_lbl = self._in_lat_group, self._lat_label
        self._in_lat_group, self._lat_label = True, label
        try:
            yield
        finally:
            self.flush_lat(label)
            self._in_lat_group, self._lat_label = prev, prev_lbl


# ---------------------------------------------------------------------------
# ambient scopes
# ---------------------------------------------------------------------------

def get_batcher() -> FlightBatcher | None:
    return comm.get_batcher()


@contextlib.contextmanager
def flight_scope(enabled: bool = True) -> Iterator[FlightBatcher | None]:
    """Round-compress every opening recorded inside. Nesting installs a
    fresh batcher (the inner scope flushes at its own boundary)."""
    if not enabled:
        yield None
        return
    fb = FlightBatcher()
    prev = comm.set_batcher(fb)
    try:
        yield fb
    finally:
        fb.flush()
        fb.flush_lat()
        comm.set_batcher(prev)


def fused_group(label: str):
    """Annotate a group of independent ops: one flight when a batcher is
    ambient, a no-op otherwise (the eager path stays eager)."""
    fb = get_batcher()
    return fb.fused_group(label) if fb is not None else \
        contextlib.nullcontext()


@contextlib.contextmanager
def lat_scope(label: str) -> Iterator[None]:
    """Coalesce independent comparison batches into one lat flight.

    Self-sufficient: installs a scoped batcher when none is ambient, so
    QuickSelect's per-wave partitions compress without requiring the
    caller to open a full flight_scope.
    """
    fb = get_batcher()
    if fb is not None:
        with fb.lat_group(label):
            yield
        return
    with flight_scope() as fb:
        with fb.lat_group(label):
            yield


def barrier() -> None:
    """Force the pending segment onto the wire (dependency boundary)."""
    fb = get_batcher()
    if fb is not None:
        fb.flush()


# ---------------------------------------------------------------------------
# analytic replay (the costs.py mirror)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupBegin:
    label: str


class GroupEnd:
    pass


GROUP_END = GroupEnd()


def compress_events(events) -> comm.Ledger:
    """Replay an eager record stream (CostRecords interleaved with
    GroupBegin/GROUP_END markers) through a FlightBatcher.

    This IS the analytic mirror's fusion step: flush semantics exist
    once, here, so `costs.proxy_exec_cost(fused=True)` and the executed
    stream can only diverge if the event stream itself is wrong — which
    the record-for-record tests catch.

    The replay is hermetic: it opens its own ledger and pins the wave
    multiplier to 1, so calling the analytic mirror from inside a
    `comm.wave_scope` (e.g. executor instrumentation) cannot inflate
    the per-batch records it predicts.
    """
    with comm.ledger_scope() as led:
        # hermetic also against wire capture: the replay is an analytic
        # mirror, not an execution — it must never append to an ambient
        # WireTape
        with comm.wave_scope(1), comm.wire_tape_scope(None), \
                flight_scope() as fb:
            for e in events:
                if isinstance(e, GroupBegin):
                    fb.flush()
                    fb._label = e.label
                elif isinstance(e, GroupEnd):
                    fb.flush(fb._label)
                    fb._label = None
                else:
                    comm.record(e.op, rounds=e.rounds, nbytes=e.nbytes,
                                numel=e.numel, flops=e.flops, tag=e.tag)
    return led
