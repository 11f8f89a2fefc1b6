"""Communication cost accounting + network delay model.

Every MPC op that talks to the wire records a CostRecord into the ambient
Ledger (a context-scoped accumulator). Records are *structural* — rounds
and bytes are functions of static shapes — so accounting is exact whether
ops run eagerly or under trace.

Delay model (matches the paper's experiment setup, §5.1):
  serial_time   = rounds * rtt_latency + bytes_on_wire / bandwidth + compute
  overlapped    = the IO scheduler (core/iosched.py) computes a makespan
                  where comm of batch i overlaps compute of batch i+1 and
                  latency-bound ops are coalesced across batches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class NetProfile:
    name: str
    bandwidth_Bps: float     # per-direction point-to-point
    latency_s: float         # one round-trip

    def time(self, rounds: float, nbytes: float, compute_s: float = 0.0) -> float:
        return rounds * self.latency_s + nbytes / self.bandwidth_Bps + compute_s


# Paper's WAN emulation: 100 MB/s, 100 ms (Section 5.1).
WAN = NetProfile("wan", 100e6, 100e-3)
# TPU v5e inter-pod data-center network (deployment projection).
POD_DCN = NetProfile("pod_dcn", 25e9, 50e-6)
# Intra-pod ICI (per-link), used by roofline collective term.
ICI = NetProfile("ici", 50e9, 1e-6)

# name -> profile, for CLI flags (--net) and ExecConfig.net: one registry
# so the delay model and the socket pacer are always parameterized by
# the same profile object.
PROFILES = {"wan": WAN, "pod_dcn": POD_DCN, "ici": ICI}


@dataclasses.dataclass
class CostRecord:
    op: str
    rounds: int
    nbytes: int          # total bytes on the wire (both directions)
    numel: int = 0
    flops: int = 0       # local per-party compute, for the overlap model
    tag: str = ""        # scheduler class: "bw" (bandwidth-bound) | "lat"
                         # | "offline" (dealer bytes, streamed pre-phase)
    wave: int = 1        # batches serviced by this flight (executor waves)


class Ledger:
    """Accumulates CostRecords; queried by benchmarks and the scheduler."""

    def __init__(self) -> None:
        self.records: list[CostRecord] = []

    def add(self, rec: CostRecord) -> None:
        self.records.append(rec)

    # ---- aggregates -------------------------------------------------
    @property
    def rounds(self) -> int:
        return sum(r.rounds for r in self.records)

    @property
    def nbytes(self) -> int:
        """Online bytes-on-wire. Offline (dealer) bytes are a separate
        channel: streamed ahead of the phase, priced by
        `offline_nbytes`, never by the delay model."""
        return sum(r.nbytes for r in self.records if r.tag != "offline")

    @property
    def offline_nbytes(self) -> int:
        """Dealer-shipped correlated-randomness bytes (Beaver triples,
        truncation pairs). Zero for dealer-free backends (3pc)."""
        return sum(r.nbytes for r in self.records if r.tag == "offline")

    @property
    def flops(self) -> int:
        return sum(r.flops for r in self.records)

    # ---- scheduler views (tagged flight classes, paper §4.4) --------
    def rounds_tagged(self, tag: str) -> int:
        return sum(r.rounds for r in self.records if r.tag == tag)

    @property
    def lat_rounds(self) -> int:
        return self.rounds_tagged("lat")

    @property
    def bw_rounds(self) -> int:
        return self.rounds_tagged("bw")

    def serial_time(self, net: NetProfile, flops_per_s: float = 10e12) -> float:
        return net.time(self.rounds, self.nbytes, self.flops / flops_per_s)

    def offline_by_op(self) -> dict[str, tuple[int, int]]:
        """op -> (numel, nbytes) totals over the offline (dealer)
        records — the per-op demand one phase batch puts on the dealer
        channel. The serve/ dealer pool multiplies these by wave lanes
        to size its pre-generation orders from a TraceEngine probe."""
        out: dict[str, tuple[int, int]] = {}
        for r in self.records:
            if r.tag == "offline":
                n, b = out.get(r.op, (0, 0))
                out[r.op] = (n + r.numel, b + r.nbytes)
        return out

    def by_op(self) -> dict[str, CostRecord]:
        out: dict[str, CostRecord] = {}
        for r in self.records:
            if r.op not in out:
                out[r.op] = CostRecord(r.op, 0, 0, 0, 0, r.tag)
            agg = out[r.op]
            agg.rounds += r.rounds
            agg.nbytes += r.nbytes
            agg.numel += r.numel
            agg.flops += r.flops
        return out

    def scaled(self, k: float) -> "Ledger":
        """Ledger for k identical repetitions of this workload."""
        led = Ledger()
        for r in self.records:
            led.add(CostRecord(r.op, int(r.rounds * k), int(r.nbytes * k),
                               int(r.numel * k), int(r.flops * k), r.tag))
        return led


# ---------------------------------------------------------------------------
# wire capture — the record execution hook (repro/net)
# ---------------------------------------------------------------------------
#
# When a WireTape is ambient (the executor's --wire mode), every ONLINE
# record ALSO captures the flight's actual message payloads: which party
# sends how many bytes to whom, in which sub-round. The PartyRuntime
# (net/runtime.py) then executes the captured flights over a real
# Transport — one framed exchange per flight — and the transport-counted
# bytes must equal the ledger's `nbytes` record-for-record
# (net.reconcile). Flights whose protocol hands concrete share tensors
# to `record(payload=...)` ship those exact bytes; modeled
# functionalities (the §4.1 comparison, the SPDZ sacrifice open) ship
# deterministic filler of exactly the modeled size — the wire carries
# real frames either way, only the *content* is synthetic.

@dataclasses.dataclass
class WaveTiming:
    """Device-side timestamps of one executed wave (seconds relative to
    the phase's t0). `start_s` is when dispatch of the wave's forward
    began, `dispatch_s` when the (async) dispatch returned, `ready_s`
    when the CUDA event recorded after the wave was seen complete —
    under the double-buffered schedule that is one wave later than its
    dispatch, so ready - start includes the overlap the schedule is
    buying."""
    wave: int
    lanes: int
    devices_used: int
    start_s: float
    dispatch_s: float
    ready_s: float = 0.0


@dataclasses.dataclass
class DeviceReport:
    """What one executed phase did on the device. `placement` records
    how the wave/party axes were realized ("none": one device, the only
    placement ported so far). The combine_* counters are the
    kernels/ops.secure_matmul launch deltas over the phase and the
    matmul_* counters the kernels/ops.ring_matmul ones — the witness
    that the ring products ran through the CUDA kernels ("kernel") and
    not the plain torch version ("ref", CPU tensors only)."""
    placement: str
    n_devices: int
    mesh_axes: dict
    waves: list = dataclasses.field(default_factory=list)
    combine_kernel: int = 0
    combine_ref: int = 0
    combine_padded: int = 0
    matmul_kernel: int = 0
    matmul_ref: int = 0

    @property
    def device_makespan_s(self) -> float:
        """Measured device-side makespan: first dispatch start to last
        wave ready, from the double-buffer loop's own timestamps."""
        if not self.waves:
            return 0.0
        return (max(w.ready_s for w in self.waves)
                - min(w.start_s for w in self.waves))

    def as_dict(self) -> dict:
        return {
            "placement": self.placement,
            "n_devices": self.n_devices,
            "mesh_axes": dict(self.mesh_axes),
            "device_makespan_s": self.device_makespan_s,
            "combine_kernel": self.combine_kernel,
            "combine_ref": self.combine_ref,
            "combine_padded": self.combine_padded,
            "matmul_kernel": self.matmul_kernel,
            "matmul_ref": self.matmul_ref,
            "waves": [dataclasses.asdict(w) for w in self.waves],
        }


@dataclasses.dataclass(frozen=True)
class WireMsg:
    """One point-to-point message of a flight: src -> dst, in sub-round
    `rnd` (multi-round flights — comparisons, ABY3 trunc2 — serialize
    their sub-rounds on the wire)."""
    src: int
    dst: int
    data: bytes
    rnd: int = 0


@dataclasses.dataclass(frozen=True)
class WireFlight:
    """One captured flight: the ledger record it mirrors plus the
    per-party messages that realize it on a transport."""
    op: str
    rounds: int
    nbytes: int
    tag: str
    msgs: tuple[WireMsg, ...]


def _data_bytes(x) -> bytes | None:
    """Serialize one payload entry; None when the value is abstract
    (a batched tensor under vmap, a meta tensor of the probe) — the
    caller falls back to synthesized filler of the recorded size. Any
    other tensor is read, and a failure to read it raises: filler in
    place of a concrete share would ship zeros that still reconcile."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    import torch
    if x.is_meta or torch._C._functorch.is_batchedtensor(x):
        return None
    return x.detach().cpu().numpy().tobytes()


def synth_msgs(nbytes: int, rounds: int, n_parties: int) -> tuple[WireMsg, ...]:
    """Deterministic filler messages summing to EXACTLY nbytes, spread
    over the flight's sub-rounds and the canonical directed-link pattern
    (duplex pair for 2 parties, the ring for 3+). Used for modeled
    functionalities that record wire cost without materializing message
    tensors."""
    if n_parties >= 3:
        links = [(i, (i + 1) % n_parties) for i in range(n_parties)]
    else:
        links = [(0, 1), (1, 0)]
    rounds = max(1, rounds)
    msgs: list[WireMsg] = []
    left = nbytes
    cells = rounds * len(links)
    per = nbytes // cells
    for r in range(rounds):
        for li, (s, d) in enumerate(links):
            size = per
            if r == rounds - 1 and li == len(links) - 1:
                size = left                    # remainder on the last cell
            msgs.append(WireMsg(s, d, b"\x00" * size, r))
            left -= size
    return tuple(msgs)


def normalize_payload(payload, nbytes: int, rounds: int,
                      n_parties: int) -> tuple[WireMsg, ...]:
    """Payload entries ((src, dst, data[, rnd]) tuples or WireMsg) ->
    serialized WireMsg tuple whose sizes MUST sum to the recorded nbytes
    — the capture-time half of the byte reconciliation contract. Falls
    back to `synth_msgs` when any entry is abstract."""
    if payload is None:
        return synth_msgs(nbytes, rounds, n_parties)
    msgs: list[WireMsg] = []
    for e in payload:
        if isinstance(e, WireMsg):
            msgs.append(e)
            continue
        src, dst, data = e[0], e[1], e[2]
        rnd = e[3] if len(e) > 3 else 0
        raw = _data_bytes(data)
        if raw is None:                        # abstract value: synthesize
            return synth_msgs(nbytes, rounds, n_parties)
        msgs.append(WireMsg(int(src), int(dst), raw, int(rnd)))
    total = sum(len(m.data) for m in msgs)
    if total != nbytes:
        raise ValueError(
            f"wire payload carries {total} bytes but the ledger record "
            f"prices {nbytes}: the protocol's payload and its cost model "
            f"have diverged")
    return tuple(msgs)


class WireTape:
    """Ordered capture of every online flight of an execution — the
    flight plan `net.PartyRuntime` replays over a real transport.
    `n_parties` is the WIRE party count (backend.n_wire_parties — spdz2pc
    stacks 4 share rows but runs 2 parties)."""

    def __init__(self, n_parties: int):
        self.n_parties = n_parties
        self.flights: list[WireFlight] = []

    def add(self, op: str, rounds: int, nbytes: int, tag: str,
            payload=None) -> None:
        msgs = normalize_payload(payload, nbytes, rounds, self.n_parties)
        self.flights.append(WireFlight(op, rounds, nbytes, tag, msgs))

    @property
    def nbytes(self) -> int:
        return sum(f.nbytes for f in self.flights)

    def link_frames(self) -> dict:
        """DATA frames per directed link, in party-loop send order —
        the population `net.faults.FaultPlan` places faults over (a
        deterministic function of the tape alone)."""
        counts: dict = {}
        for f in self.flights:
            for r in sorted({m.rnd for m in f.msgs} or {0}):
                for m in f.msgs:
                    if m.rnd == r:
                        counts[(m.src, m.dst)] = \
                            counts.get((m.src, m.dst), 0) + 1
        return counts

    def link_nbytes(self) -> dict:
        """Payload bytes per directed link — what each transport
        link's goodput counter must equal after any replay, faulted or
        not."""
        out: dict = {}
        for f in self.flights:
            for m in f.msgs:
                out[(m.src, m.dst)] = out.get((m.src, m.dst), 0) + len(m.data)
        return out


_state = threading.local()


def get_ledger() -> Ledger | None:
    return getattr(_state, "ledger", None)


def get_wire_tape() -> WireTape | None:
    return getattr(_state, "wire_tape", None)


@contextlib.contextmanager
def wire_tape_scope(tape: WireTape | None) -> Iterator[WireTape | None]:
    """Capture every online flight recorded inside into `tape` (pass
    None to explicitly suppress an outer capture, e.g. hermetic analytic
    replays)."""
    prev = get_wire_tape()
    _state.wire_tape = tape
    try:
        yield tape
    finally:
        _state.wire_tape = prev


def get_wave() -> int:
    return getattr(_state, "wave", 1)


def get_batcher():
    """Ambient flight batcher (mpc/fusion.py), or None when eager."""
    return getattr(_state, "batcher", None)


def set_batcher(batcher):
    """Install a flight batcher; returns the previous one (restore it)."""
    prev = get_batcher()
    _state.batcher = batcher
    return prev


def record(op: str, rounds: int, nbytes: int, numel: int = 0,
           flops: int = 0, tag: str = "bw", payload=None) -> None:
    """Record one wire interaction into the ambient Ledger.

    Inside a wave_scope(W) the op services W coalesced batches in a
    single trace (the executor vmaps the wave), so the structural shapes
    seen here are per-batch: bytes/numel/flops scale by W. Rounds follow
    the paper's §4.4 split — latency-bound flights ("lat") are stacked
    into ONE message per wave (rounds paid once), bandwidth-bound Beaver
    openings ("bw") stay one flight per batch: their wire time is what
    the overlap stage hides, and serializing them costs no extra RTTs
    on a saturated link.

    `payload` is the record's EXECUTION hook: the flight's actual
    messages as (src, dst, tensor_or_bytes[, rnd]) entries. It is only
    consulted when a WireTape is ambient (`--wire` runs, which execute
    eagerly at wave 1 so tensors are concrete); modeled records pass
    None and capture as synthesized filler of the exact recorded size.
    """
    led = get_ledger()
    if led is None:
        return
    tape = get_wire_tape()
    fb = get_batcher()
    if fb is not None and fb.absorb(op, rounds, nbytes, numel, flops, tag,
                                    payload=payload):
        return                        # deferred: rides a fused flight
    w = get_wave()
    if w > 1 and tag != "lat":
        rounds = rounds * w
    led.add(CostRecord(op, rounds, nbytes * w, numel * w, flops * w, tag,
                       wave=w))
    if tape is not None and tag != "offline":
        # offline (dealer) bytes never ride the online wire — the tape
        # mirrors exactly the records Ledger.nbytes counts
        tape.add(op, rounds, nbytes * w, tag,
                 payload if w == 1 else None)


@contextlib.contextmanager
def wave_scope(wave: int) -> Iterator[None]:
    """Mark that every op recorded inside services `wave` coalesced
    batches in one flight (the executor's vmapped wave trace)."""
    prev = get_wave()
    _state.wave = wave
    try:
        yield
    finally:
        _state.wave = prev


@contextlib.contextmanager
def ledger_scope() -> Iterator[Ledger]:
    prev = get_ledger()
    led = Ledger()
    _state.ledger = led
    try:
        yield led
    finally:
        _state.ledger = prev
