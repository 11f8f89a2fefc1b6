"""Party-to-party transports — the real wire under the flight ledger;
the port of repro/net/transport.py, frame for frame.

Two backends behind one blocking point-to-point interface:

  LocalTransport   in-process queues. Deterministic, unpaced, test-grade:
                   what the fault-tolerance tests and the `--wire local`
                   smoke path drive.
  SocketTransport  localhost TCP, one full-duplex connection per party
                   pair, length-prefixed framed messages. Every directed
                   link has a token-bucket pacer (bandwidth) and the
                   receiver injects one-way latency from a
                   `comm.NetProfile`, so any modeled network can be
                   EMULATED on a real wire — the measured makespan of a
                   flight plan is then an experiment, not a formula.

Framing (SocketTransport): every message is one frame

    !B  kind        DATA (payload, counted) | BEAT (heartbeat) | SYNC
                    | ACK (reliability control)
    !d  depart_ts   sender monotonic clock AFTER pacing (Linux
                    CLOCK_MONOTONIC is boot-anchored, so it is
                    comparable across processes on one host)
    !I  seq         per-link monotonic sequence number (DATA frames sent
                    through ReliableTransport; UNSEQ otherwise)
    !I  length      payload bytes

followed by `length` payload bytes. The receiver thread delays delivery
until `depart_ts + one_way_latency`, which serializes subsequent frames
on the link exactly like propagation delay does.

Reliability (`ReliableTransport`): a wrapper that works identically over
both backends (and over `faults.ChaosTransport`). Every DATA frame gets
a per-link monotonic sequence number and sits in a bounded resend buffer
until the receiver's cumulative ACK covers it; the receiver deduplicates
(seq < expected), discards out-of-order frames past a gap (go-back-N),
and turns a recv timeout into an `ft.retry`-driven resend request with
exponential backoff. A link the base transport declares dead is
reconnected (TCP redial/re-accept) and the unACKed window retransmitted.

Byte accounting: `data_bytes` counts each DATA payload's FIRST
transmission only (goodput — the reconciliation target is the ledger's
`nbytes`, which prices share bytes once). Retransmissions of an
already-counted sequence number land in `retrans_bytes` and ACK payloads
in `ack_bytes` — a separate RETRANS channel, so chaos recovery never
bends the goodput ledger match. Frame headers and BEAT/SYNC frames are
excluded everywhere.

Link death is LOUD: once a link's sender or receiver thread dies, plain
`send`/`recv` on that link raise `WireDown("link down: ...")` instead of
silently blocking until a timeout; only `ReliableTransport` recovers.

A frame's length field is `!I`: `SocketTransport.send` refuses a message
of MAX_FRAME bytes or more with a WireError, where a sender thread would
otherwise die on the pack and leave its peer waiting (a spawned party
reports the error to `PartyRuntime`, which raises it).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import socket
import struct
import threading
import time

from repro_torch.runtime import ft

# frame kinds
DATA, BEAT, SYNC, ACK = 0, 1, 2, 3

_HEADER = struct.Struct("!BdII")     # kind, depart_ts, seq, length
_ACK_BODY = struct.Struct("!BIIB")   # kind, cum_committed, resend_from, want
# kinds under reliable delivery: protocol payloads AND barrier frames —
# a reset that eats a SYNC release would otherwise stall a party one
# flight behind its peers forever
RELIABLE_KINDS = (DATA, SYNC)
UNSEQ = 0xFFFFFFFF                   # header seq for unsequenced frames
MAX_FRAME = 1 << 32                  # first length the !I field cannot hold

# a paced sender never sleeps longer than this per chunk, so huge frames
# on a slow profile still make progress and ctrl-C stays responsive
_MAX_SLEEP_S = 0.25


class WireError(RuntimeError):
    """Transport-level failure (timeout, short read, protocol abuse)."""


class WireDown(WireError):
    """The link is known dead (peer closed, reset, crashed): raised
    immediately on send/recv instead of blocking until a timeout."""


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """What SocketTransport reads of a `comm.NetProfile`, as a value of
    this torch-free package: a spawned party unpickles it without
    importing the port's MPC package (and with it torch)."""
    bandwidth_Bps: float
    latency_s: float


class TokenBucket:
    """Per-link bandwidth pacer: `throttle(n)` blocks until n bytes of
    budget have accrued at `rate_Bps`. Burst capacity defaults to 64 KiB
    or 50 ms of line rate, whichever is larger."""

    def __init__(self, rate_Bps: float, burst: float | None = None, *,
                 clock=time.monotonic, sleep=time.sleep):
        self.rate = float(rate_Bps)
        self.burst = float(burst if burst is not None
                           else max(65536.0, self.rate * 0.05))
        self._tokens = self.burst
        self._t = clock()
        self._clock, self._sleep = clock, sleep

    def throttle(self, nbytes: int) -> float:
        """Consume nbytes of budget, sleeping until the deficit is paid
        off; returns seconds slept. Deficit-based so a frame LARGER than
        the burst capacity still paces correctly (it waits out its own
        line time) instead of waiting for a token level the cap can
        never reach."""
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        self._tokens -= nbytes
        slept = 0.0
        while self._tokens < 0:
            wait = min(-self._tokens / self.rate, _MAX_SLEEP_S)
            self._sleep(wait)
            slept += wait
            now = self._clock()
            self._tokens += (now - self._t) * self.rate
            self._t = now
        return slept


class Transport:
    """Blocking point-to-point byte transport between n parties.

    send() is non-blocking (enqueue); recv() blocks until the next frame
    of the requested kind on the (src -> dst) link arrives. Per-link
    FIFO order is guaranteed within a kind. DATA payload bytes are
    counted by channel: first transmission of a sequence number (or any
    unsequenced frame) into `data_bytes` (goodput), re-transmissions
    into `retrans_bytes`, ACK payloads into `ack_bytes`.
    """

    n_parties: int

    def __init__(self, n_parties: int):
        self.n_parties = n_parties
        self.data_bytes: dict[tuple[int, int], int] = {}
        self.retrans_bytes: dict[tuple[int, int], int] = {}
        self.ack_bytes = 0
        self.n_frames = 0
        self.n_retrans_frames = 0
        self.n_ack_frames = 0
        # per-link goodput watermark: seqs below it have been counted
        self._tx_counted: dict[tuple[int, int], int] = {}
        self._lock = threading.Lock()

    def _count(self, src: int, dst: int, n: int, kind: int,
               seq: int | None = None) -> None:
        with self._lock:
            self.n_frames += 1
            if kind == ACK:
                self.ack_bytes += n
                self.n_ack_frames += 1
            elif kind == DATA:
                link = (src, dst)
                if seq is not None and seq < self._tx_counted.get(link, 0):
                    # retransmission of an already-counted frame — the
                    # RETRANS channel, never goodput
                    self.retrans_bytes[link] = \
                        self.retrans_bytes.get(link, 0) + n
                    self.n_retrans_frames += 1
                else:
                    self.data_bytes[link] = self.data_bytes.get(link, 0) + n
                    if seq is not None:
                        self._tx_counted[link] = seq + 1

    @property
    def total_data_bytes(self) -> int:
        with self._lock:
            return sum(self.data_bytes.values())

    @property
    def total_retrans_bytes(self) -> int:
        with self._lock:
            return sum(self.retrans_bytes.values())

    def restore_accounting(self, data_bytes: dict[tuple[int, int], int],
                           tx_counted: dict[tuple[int, int], int]) -> None:
        """Crash-recovery hook: seed the goodput counters and watermarks
        of a fresh (respawned-party) transport from a durable cursor so
        re-sent flights are counted exactly once across incarnations.
        Monotone (max-merge): a SHARED transport (local mode) already
        holds counts past the cursor — the watermark and goodput never
        rewind, so the crashed incarnation's replayed sends land in the
        RETRANS channel."""
        with self._lock:
            for k, v in data_bytes.items():
                self.data_bytes[k] = max(self.data_bytes.get(k, 0), v)
            for k, v in tx_counted.items():
                self._tx_counted[k] = max(self._tx_counted.get(k, 0), v)

    # -- interface ------------------------------------------------------
    def send(self, src: int, dst: int, data: bytes, kind: int = DATA,
             seq: int | None = None) -> None:
        raise NotImplementedError

    def recv_seq(self, dst: int, src: int, kind: int = DATA,
                 timeout: float | None = None) -> tuple[int | None, bytes]:
        raise NotImplementedError

    def recv(self, dst: int, src: int, kind: int = DATA,
             timeout: float | None = None) -> bytes:
        return self.recv_seq(dst, src, kind, timeout)[1]

    def try_recv(self, dst: int, src: int, kind: int = DATA) -> bytes | None:
        """Non-blocking recv: None when no frame is waiting."""
        try:
            return self.recv(dst, src, kind, timeout=0.0)
        except WireError:
            return None

    def link_down(self, peer: int) -> str | None:
        """Reason string when the link to `peer` is known dead."""
        return None

    def reconnect(self, peer: int, timeout: float = 10.0) -> None:
        """Re-establish a dead link (socket backend); no-op elsewhere."""

    def purge(self, src: int, dst: int, kind: int = DATA) -> int:
        """Drop undelivered in-flight frames on a link (fault injection
        uses this to model a reset's lost window); returns frames dropped."""
        return 0

    def close(self) -> None:
        pass


class LocalTransport(Transport):
    """In-process queue transport: deterministic and instantaneous.
    The test-grade backend — heartbeat/straggler tests and `--wire
    local` runs exchange the same frames as the socket backend, minus
    pacing. Queue items carry (seq, payload) so the reliability layer
    behaves identically over both backends."""

    def __init__(self, n_parties: int):
        super().__init__(n_parties)
        self._q: dict[tuple[int, int, int], queue.Queue] = {}
        self._qlock = threading.Lock()

    def _queue(self, src: int, dst: int, kind: int) -> queue.Queue:
        k = (src, dst, kind)
        with self._qlock:
            q = self._q.get(k)
            if q is None:
                q = self._q[k] = queue.Queue()
            return q

    def send(self, src: int, dst: int, data: bytes, kind: int = DATA,
             seq: int | None = None) -> None:
        self._count(src, dst, len(data), kind, seq)
        self._queue(src, dst, kind).put((seq, bytes(data)))

    def recv_seq(self, dst: int, src: int, kind: int = DATA,
                 timeout: float | None = None) -> tuple[int | None, bytes]:
        try:
            if timeout == 0.0:
                return self._queue(src, dst, kind).get_nowait()
            return self._queue(src, dst, kind).get(timeout=timeout)
        except queue.Empty:
            raise WireError(
                f"recv timeout: party {dst} waiting on {src} (kind {kind})")

    def purge(self, src: int, dst: int, kind: int = DATA) -> int:
        q = self._queue(src, dst, kind)
        n = 0
        while True:
            try:
                q.get_nowait()
                n += 1
            except queue.Empty:
                return n


def free_ports(n: int) -> list[int]:
    """n distinct free loopback TCP ports (bound simultaneously so they
    cannot collide with each other, then released for the parties)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        return ports
    finally:
        for s in socks:
            s.close()


def _recvall(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise WireError("peer closed connection mid-frame")
        buf += chunk
    return bytes(buf)


class SocketTransport(Transport):
    """Localhost TCP transport for ONE party of a full mesh.

    Connection setup: party p listens on ports[p]; it accepts one
    connection from every higher-numbered party and dials every
    lower-numbered one (a 1-byte hello identifies the dialer), yielding
    one full-duplex socket per pair. Each directed outgoing link gets a
    sender thread (so protocol-level simultaneous exchanges can never
    head-of-line deadlock on TCP buffers) that applies token-bucket
    pacing per `profile.bandwidth_Bps`; each incoming socket gets a
    receiver thread that demultiplexes frames by kind and delays
    delivery to `depart_ts + profile.latency_s / 2` (one-way latency —
    the profile's `latency_s` is a round trip).

    A link whose sender or receiver thread dies (peer reset, peer crash)
    is flagged down: subsequent `send`/`recv` on it raise `WireDown`
    immediately. `reconnect(peer)` re-establishes the pair — the
    lower-numbered end re-listens on its original port, the higher end
    redials — and restarts the link threads; `ReliableTransport` then
    retransmits the lost window.
    """

    def __init__(self, n_parties: int, party: int, ports: list[int],
                 profile=None, *, connect_timeout: float = 20.0,
                 absent: tuple = ()):
        super().__init__(n_parties)
        self.party = party
        self.profile = profile
        self.one_way_s = (profile.latency_s / 2.0) if profile else 0.0
        self._ports = list(ports)
        self._absent = frozenset(absent)   # degraded mode: dead parties
        self._socks: dict[int, socket.socket] = {}
        self._inbox: dict[tuple[int, int], queue.Queue] = {
            (peer, kind): queue.Queue()
            for peer in range(n_parties) if peer != party
            for kind in (DATA, BEAT, SYNC, ACK)}
        self._outbox: dict[int, queue.Queue] = {}
        self._senders: list[threading.Thread] = []
        self._receivers: list[threading.Thread] = []
        self._closed = threading.Event()
        self._down: dict[int, str] = {}
        self._gen: dict[int, int] = {}        # link thread generation
        self._reconnect_lock = threading.Lock()
        self._repair_lock = threading.Lock()
        self._repairing: set[int] = set()
        self._connect(ports, connect_timeout)
        for peer, sock in list(self._socks.items()):
            self._spawn_link_threads(peer, sock)

    # -- mesh setup -----------------------------------------------------
    def _dial(self, peer: int, timeout: float) -> socket.socket:
        """Dial a peer's listening port, retrying while it boots (or
        reboots, on crash recovery) — ft.retry owns the backoff."""
        def attempt():
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.connect(("127.0.0.1", self._ports[peer]))
            except OSError:
                s.close()
                raise
            return s
        try:
            s = ft.retry(attempt, attempts=max(8, int(timeout / 0.02)),
                         backoff_s=0.02, max_backoff_s=0.25,
                         retriable=(OSError,), deadline_s=timeout)
        except OSError:
            raise WireError(
                f"party {self.party} could not reach party {peer} on "
                f"port {self._ports[peer]}")
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(struct.pack("!B", self.party))     # hello: who dials
        return s

    def _connect(self, ports: list[int], timeout: float) -> None:
        p = self.party
        higher = [x for x in range(p + 1, self.n_parties)
                  if x not in self._absent]
        listener = None
        try:
            if higher:                      # someone will dial us
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                listener.bind(("127.0.0.1", ports[p]))
                listener.listen(self.n_parties)
                listener.settimeout(timeout)
            # dial every lower-numbered party (retry while it boots)
            for peer in range(p):
                if peer not in self._absent:
                    self._socks[peer] = self._dial(peer, timeout)
            # accept every higher-numbered party
            for _ in higher:
                try:
                    s, _addr = listener.accept()
                except socket.timeout:
                    raise WireError(f"party {p}: accept timed out")
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                (peer,) = struct.unpack("!B", _recvall(s, 1))
                self._socks[peer] = s
        finally:
            # the listener must die on EVERY exit path — a timed-out
            # accept or a failed dial used to leak it (and pin the port)
            if listener is not None:
                listener.close()

    def _spawn_link_threads(self, peer: int, sock: socket.socket) -> None:
        gen = self._gen.get(peer, 0) + 1
        self._gen[peer] = gen
        ob = self._outbox.setdefault(peer, queue.Queue())
        ts = threading.Thread(target=self._sender,
                              args=(peer, sock, ob, gen), daemon=True)
        tr = threading.Thread(target=self._receiver,
                              args=(peer, sock, gen), daemon=True)
        ts.start()
        tr.start()
        self._senders.append(ts)
        self._receivers.append(tr)

    # -- link health ----------------------------------------------------
    def _mark_down(self, peer: int, reason: str,
                   gen: int | None = None) -> None:
        if self._closed.is_set():
            return
        if gen is not None and self._gen.get(peer) != gen:
            # a stale link thread dying on the OLD socket after a
            # reconnect already replaced it — the new link is healthy;
            # re-marking it down here would tear it straight back down
            # (reconnect storm)
            return
        self._down.setdefault(peer, reason)
        # Self-healing: drive the reconnect from a background thread so
        # recovery never depends on WHICH op a party is blocked in. A
        # party stuck receiving on a healthy link would otherwise never
        # re-listen for a respawned peer that is trying to dial back in
        # (three-way deadlock: respawned party can't finish _connect,
        # survivors can't make progress without it).
        if peer in self._absent:
            return
        with self._repair_lock:
            if peer in self._repairing:
                return
            self._repairing.add(peer)
        threading.Thread(target=self._repair, args=(peer,),
                         daemon=True).start()

    def _repair(self, peer: int) -> None:
        try:
            while not self._closed.is_set() and \
                    self._down.get(peer) is not None:
                try:
                    self.reconnect(peer, timeout=2.0)
                except (WireError, OSError):
                    time.sleep(0.05)
        finally:
            with self._repair_lock:
                self._repairing.discard(peer)

    def link_down(self, peer: int) -> str | None:
        return self._down.get(peer)

    def inject_reset(self, peer: int) -> None:
        """Fault-injection hook: hard-close the socket to `peer` (both
        ends' link threads die — the remote sees a reset/EOF)."""
        sock = self._socks.get(peer)
        self._mark_down(peer, "injected connection reset")
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()

    def reconnect(self, peer: int, timeout: float = 10.0) -> None:
        """Re-establish a down link. The lower-numbered end re-listens
        on its original port and accepts; the higher end redials — the
        same orientation as initial setup, so concurrent recovery from
        both ends converges. Raises WireError if the peer does not show
        up within `timeout`."""
        if peer in self._absent:
            raise WireError(f"party {peer} is absent (degraded mesh)")
        with self._reconnect_lock:
            if self._closed.is_set():
                raise WireError("transport closed")
            if self._down.get(peer) is None:
                return                       # already recovered
            old = self._socks.pop(peer, None)
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            if peer < self.party:
                sock = self._dial(peer, timeout)
            else:
                sock = self._accept_reconnect(peer, timeout)
            self._socks[peer] = sock
            self._down.pop(peer, None)
            self._spawn_link_threads(peer, sock)

    def _accept_reconnect(self, peer: int, timeout: float) -> socket.socket:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            listener.bind(("127.0.0.1", self._ports[self.party]))
            listener.listen(self.n_parties)
            listener.settimeout(0.5)
            deadline = time.monotonic() + timeout
            while True:
                if time.monotonic() > deadline:
                    raise WireError(
                        f"party {self.party}: reconnect accept timed out "
                        f"waiting for {peer}")
                try:
                    s, _addr = listener.accept()
                except socket.timeout:
                    continue
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                (who,) = struct.unpack("!B", _recvall(s, 1))
                if who == peer:
                    return s
                if self._down.get(who) is not None:
                    # a different peer reconnecting through the same
                    # window: adopt its link too, keep waiting for ours
                    self._socks[who] = s
                    self._down.pop(who, None)
                    self._spawn_link_threads(who, s)
                else:
                    s.close()
        finally:
            listener.close()

    # -- link threads ---------------------------------------------------
    def _sender(self, peer: int, sock: socket.socket, ob: queue.Queue,
                gen: int):
        bucket = TokenBucket(self.profile.bandwidth_Bps) if self.profile \
            else None
        while not self._closed.is_set() and self._gen.get(peer) == gen:
            try:
                item = ob.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            kind, seq, data = item
            if bucket is not None and kind == DATA and data:
                bucket.throttle(len(data))
            frame = _HEADER.pack(kind, time.monotonic(),
                                 UNSEQ if seq is None else seq,
                                 len(data)) + data
            try:
                sock.sendall(frame)
            except OSError as e:
                self._mark_down(peer, f"send failed: {e}", gen)
                return

    def _receiver(self, peer: int, sock: socket.socket, gen: int):
        while not self._closed.is_set() and self._gen.get(peer) == gen:
            try:
                hdr = _recvall(sock, _HEADER.size)
                kind, depart, seq, length = _HEADER.unpack(hdr)
                data = _recvall(sock, length) if length else b""
            except (WireError, OSError) as e:
                self._mark_down(peer, f"recv failed: {e}", gen)
                return
            if self.one_way_s:
                # propagation delay: deliver no earlier than
                # departure + one-way latency (delays this link's later
                # frames too, exactly like a real pipe)
                dt = depart + self.one_way_s - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
            self._inbox[peer, kind].put(
                (None if seq == UNSEQ else seq, data))

    # -- interface ------------------------------------------------------
    def send(self, src: int, dst: int, data: bytes, kind: int = DATA,
             seq: int | None = None) -> None:
        if src != self.party:
            raise WireError(f"party {self.party} cannot send as {src}")
        if dst in self._absent:
            raise WireDown(f"link down: {src}->{dst} (party {dst} absent)")
        reason = self._down.get(dst)
        if reason is not None:
            raise WireDown(f"link down: {src}->{dst} ({reason})")
        if len(data) >= MAX_FRAME:
            raise WireError(
                f"a {len(data)}-byte message does not fit a frame: its !I "
                f"length field holds at most {MAX_FRAME - 1} bytes")
        self._count(src, dst, len(data), kind, seq)
        self._outbox[dst].put((kind, seq, bytes(data)))

    def recv_seq(self, dst: int, src: int, kind: int = DATA,
                 timeout: float | None = None) -> tuple[int | None, bytes]:
        if dst != self.party:
            raise WireError(f"party {self.party} cannot recv as {dst}")
        q = self._inbox[src, kind]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # poll in short slices so a link death surfaces as WireDown
            # immediately instead of a silent block until the timeout
            try:
                if timeout == 0.0:
                    return q.get_nowait()
                slice_t = 0.1
                if deadline is not None:
                    slice_t = min(slice_t,
                                  max(0.001, deadline - time.monotonic()))
                return q.get(timeout=slice_t)
            except queue.Empty:
                reason = self._down.get(src)
                if reason is not None:
                    raise WireDown(f"link down: {src}->{dst} ({reason})")
                if timeout == 0.0 or (deadline is not None
                                      and time.monotonic() >= deadline):
                    raise WireError(
                        f"recv timeout: party {dst} waiting on {src} "
                        f"(kind {kind})")

    def close(self) -> None:
        # drain FIRST: senders exit on the None sentinel only after every
        # already-enqueued frame is on the wire — shutting the socket
        # before that silently drops the tail of the stream
        for ob in self._outbox.values():
            ob.put(None)
        for ts in self._senders:
            ts.join(timeout=10.0)
        self._closed.set()
        for s in self._socks.values():
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


class _FrameLost(WireError):
    """Internal: a frame is missing (timeout or sequence gap) — the
    retry loop sends a resend request and backs off."""


class ReliableTransport:
    """Reliable-delivery wrapper over any Transport (Local, Socket, or a
    `faults.ChaosTransport` around either).

    Sender side: every DATA frame gets the link's next sequence number
    and is held in a bounded per-link resend buffer until the receiver's
    cumulative ACK covers it. Receiver side: in-order frames are
    delivered; duplicates (retransmissions of already-delivered seqs)
    are dropped; a gap (frame lost ahead of later arrivals) discards the
    out-of-order tail and triggers go-back-N retransmission.

    Loss recovery is receiver-driven: a recv that times out sends the
    peer an ACK frame with `want_resend` set (carrying the durable
    cumulative watermark + the resend-from seq) and retries under
    `ft.retry` with exponential backoff; peers service resend requests
    opportunistically whenever they touch the transport. A link the base
    reports down is reconnected and its unACKed window retransmitted.

    ACKs carry `rx_committed`, advanced by `ack()` — the party loop
    calls it at flight boundaries AFTER durably committing its cursor,
    so a crashed party can always re-fetch every flight past its last
    commit: peers prune their resend buffers only up to the committed
    watermark.
    """

    def __init__(self, base: Transport, *, window: int = 4096,
                 rto_s: float = 0.05, max_attempts: int = 16,
                 reconnect_timeout_s: float = 3.0,
                 sleep=time.sleep, clock=time.monotonic):
        self.base = base
        self.n_parties = base.n_parties
        self.window = window
        self.rto_s = rto_s
        self.max_attempts = max_attempts
        self.reconnect_timeout_s = reconnect_timeout_s
        self._sleep, self._clock = sleep, clock
        # all reliable state is keyed (src, dst, kind): DATA and SYNC
        # run independent sequence spaces on every directed link
        self._tx_next: dict[tuple, int] = collections.defaultdict(int)
        self._tx_buf: dict[tuple, collections.OrderedDict] = \
            collections.defaultdict(collections.OrderedDict)
        self._rx_next: dict[tuple, int] = collections.defaultdict(int)
        self._rx_committed: dict[tuple, int] = collections.defaultdict(int)
        self._slock = threading.Lock()
        # stats (the WireReport's chaos accounting)
        self.retries = 0             # timeout-triggered resend requests
        self.dup_frames = 0          # deduplicated retransmissions seen
        self.gap_frames = 0          # out-of-order frames discarded
        self.resends_honored = 0     # resend requests we served
        self.reconnects = 0
        self.recovery_s = 0.0        # time spent re-establishing links

    # -- counters proxy (the party loop reads these off the transport) --
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

    @property
    def total_retrans_bytes(self):
        return self.base.total_retrans_bytes

    # -- control --------------------------------------------------------
    def _service_control(self, me: int) -> None:
        """Drain ACK frames addressed to `me`: prune resend buffers up
        to the peer's committed watermark, honor resend requests."""
        for peer in range(self.n_parties):
            if peer == me:
                continue
            while True:
                raw = self.base.try_recv(me, peer, kind=ACK)
                if raw is None:
                    break
                k, cum, resend_from, want = _ACK_BODY.unpack(raw)
                buf = self._tx_buf[(me, peer, k)]
                for s in [s for s in buf if s < cum]:
                    del buf[s]
                if want:
                    with self._slock:
                        self.resends_honored += 1
                    for s in sorted(s for s in buf if s >= resend_from):
                        try:
                            self.base.send(me, peer, buf[s], k, seq=s)
                        except WireError:
                            break      # link down: recv path owns recovery

    def _service_sleep(self, me: int):
        """An ft.retry sleep that keeps servicing control traffic — a
        peer's resend request must never starve behind our backoff."""
        def sleep(dt: float) -> None:
            end = self._clock() + dt
            while True:
                self._service_control(me)
                left = end - self._clock()
                if left <= 0:
                    return
                self._sleep(min(left, 0.02))
        return sleep

    def ack(self, me: int, *, commit: bool = True) -> None:
        """Cumulative-ACK every incoming link. With `commit` (the party
        loop calls this AFTER durably writing its flight cursor) the
        committed watermark advances to everything received — peers may
        then prune those frames from their resend buffers."""
        for peer in range(self.n_parties):
            if peer == me:
                continue
            for k in RELIABLE_KINDS:
                link = (peer, me, k)
                if commit:
                    self._rx_committed[link] = self._rx_next[link]
                if self._rx_next[link] == 0:
                    continue           # no traffic of this kind yet
                body = _ACK_BODY.pack(k, self._rx_committed[link],
                                      self._rx_next[link], 0)
                try:
                    self.base.send(me, peer, body, kind=ACK)
                except WireError:
                    pass               # dead link: ACK again post-recovery

    def _request_resend(self, me: int, src: int, kind: int) -> None:
        link = (src, me, kind)
        body = _ACK_BODY.pack(kind, self._rx_committed[link],
                              self._rx_next[link], 1)
        try:
            self.base.send(me, src, body, kind=ACK)
        except WireError:
            pass

    def _recover_link(self, me: int, peer: int) -> None:
        """Reconnect a dead link, then go-back-N retransmit our unACKed
        window to the peer (its receiver dedups what already arrived)."""
        t0 = self._clock()
        self.base.reconnect(peer, timeout=self.reconnect_timeout_s)
        with self._slock:
            self.reconnects += 1
            self.recovery_s += self._clock() - t0
        for k in RELIABLE_KINDS:
            buf = self._tx_buf[(me, peer, k)]
            for s in sorted(buf):
                try:
                    self.base.send(me, peer, buf[s], k, seq=s)
                except WireError:
                    return

    # -- interface ------------------------------------------------------
    def send(self, src: int, dst: int, data: bytes, kind: int = DATA,
             seq: int | None = None) -> None:
        if kind not in RELIABLE_KINDS:
            return self.base.send(src, dst, data, kind)
        self._service_control(src)
        link = (src, dst, kind)
        s = self._tx_next[link]
        self._tx_next[link] = s + 1
        buf = self._tx_buf[link]
        buf[s] = data = bytes(data)
        deadline = self._clock() + self.reconnect_timeout_s * 4
        while len(buf) > self.window:
            # bounded resend buffer: wait for the peer's cumulative ACK
            self._service_control(src)
            if len(buf) <= self.window:
                break
            if self._clock() > deadline:
                raise WireError(
                    f"resend buffer full on link {src}->{dst} "
                    f"({len(buf)} unACKed frames) and no ACK arriving")
            self._sleep(self.rto_s)
        try:
            self.base.send(src, dst, data, kind, seq=s)
        except WireDown:
            # dead link: reconnect (retrying — the peer may be mid-
            # respawn) and flush the buffered window
            def recover():
                self._recover_link(src, dst)
            ft.retry(recover, attempts=self.max_attempts,
                     backoff_s=self.rto_s, max_backoff_s=1.0,
                     retriable=(WireError, OSError),
                     sleep=self._service_sleep(src), clock=self._clock)

    def recv(self, dst: int, src: int, kind: int = DATA,
             timeout: float | None = None):
        if kind not in RELIABLE_KINDS:
            # block in slices, servicing control between them — a party
            # parked waiting on advisory traffic must still answer
            # peers' resend requests or it starves their recovery
            deadline = None if timeout is None else self._clock() + timeout
            while True:
                self._service_control(dst)
                slice_t = 0.05
                if deadline is not None:
                    left = deadline - self._clock()
                    if left <= 0:
                        return self.base.recv(dst, src, kind, 0.0)
                    slice_t = min(slice_t, left)
                try:
                    return self.base.recv(dst, src, kind, slice_t)
                except WireDown:
                    raise
                except WireError:
                    continue
        link = (src, dst, kind)
        out = []

        def attempt():
            self._service_control(dst)
            deadline = self._clock() + self.rto_s
            gap = None
            while True:
                left = max(0.001, deadline - self._clock())
                try:
                    seq, data = self.base.recv_seq(dst, src, kind,
                                                   timeout=left)
                except WireDown:
                    try:
                        self._recover_link(dst, src)
                    except (WireError, OSError):
                        pass           # still down: back off, re-attempt
                    raise _FrameLost(f"link {src}->{dst} down")
                except WireError:
                    raise _FrameLost(gap or
                                     f"no frame from {src} within rto")
                want = self._rx_next[link]
                if seq is None or seq == want:
                    if seq is not None:
                        self._rx_next[link] = seq + 1
                    out.append(data)
                    return
                if seq < want:
                    with self._slock:
                        self.dup_frames += 1
                    continue           # retransmission we already have
                # gap: discard the out-of-order tail (go-back-N resends
                # it in order) and ask for retransmission once an
                # attempt. The whole tail is drained here, not one frame
                # an attempt: a tail longer than max_attempts frames
                # would otherwise exhaust the retries before the resent
                # frame, queued behind it, is read
                with self._slock:
                    self.gap_frames += 1
                if gap is None:
                    with self._slock:
                        self.retries += 1
                    self._request_resend(dst, src, kind)
                gap = f"gap on {src}->{dst}: got seq {seq}, want {want}"

        def lossy_attempt():
            try:
                attempt()
            except _FrameLost:
                with self._slock:
                    self.retries += 1
                self._request_resend(dst, src, kind)
                raise

        try:
            lossy_attempt()            # fast path: no retry machinery
            return out[0]
        except _FrameLost:
            pass
        ft.retry(lossy_attempt, attempts=self.max_attempts,
                 backoff_s=self.rto_s, max_backoff_s=1.0,
                 retriable=(_FrameLost,), sleep=self._service_sleep(dst),
                 clock=self._clock, deadline_s=timeout)
        return out[0]

    def try_recv(self, dst: int, src: int, kind: int = DATA):
        if kind not in RELIABLE_KINDS:
            return self.base.try_recv(dst, src, kind)
        try:
            return self.recv(dst, src, kind, timeout=0.0)
        except WireError:
            return None

    # -- crash-recovery state (the durable cursor's wire half) ----------
    def state_for(self, party: int) -> dict:
        """JSON-plain snapshot of this party's link state at a flight
        boundary: tx seqs (and goodput counters) for outgoing links, rx
        watermarks for incoming ones, per reliable kind. Restoring it on
        a respawned incarnation makes re-sent flights count once and
        re-received flights dedup exactly."""
        return {
            "tx_next": {f"{d}:{k}": n
                        for (s, d, k), n in self._tx_next.items()
                        if s == party},
            "rx_next": {f"{s}:{k}": n
                        for (s, d, k), n in self._rx_next.items()
                        if d == party},
            "data_bytes": {str(d): n
                           for (s, d), n in self.base.data_bytes.items()
                           if s == party},
        }

    def restore_for(self, party: int, st: dict) -> None:
        data_bytes, tx_counted = {}, {}
        for key, n in st.get("tx_next", {}).items():
            d, k = (int(x) for x in key.split(":"))
            self._tx_next[(party, d, k)] = n
            if k == DATA:
                tx_counted[(party, d)] = n
        for key, n in st.get("rx_next", {}).items():
            s, k = (int(x) for x in key.split(":"))
            self._rx_next[(s, party, k)] = n
            self._rx_committed[(s, party, k)] = n
        for d, n in st.get("data_bytes", {}).items():
            data_bytes[(party, int(d))] = n
        self.base.restore_accounting(data_bytes, tx_counted)

    def rebuffer(self, src: int, dst: int, seq: int, data: bytes,
                 kind: int = DATA) -> None:
        """Re-stock the resend buffer on crash recovery. The cursor
        persists tx seqs but not payloads — a respawned party rebuilds
        its unACKed window from the tape (sends are deterministic plan
        payloads), else a peer still missing a pre-crash frame could
        never be served. Peers' cumulative ACKs prune what they already
        committed."""
        self._tx_buf[(src, dst, kind)][seq] = bytes(data)

    def link_down(self, peer: int) -> str | None:
        return self.base.link_down(peer)

    def reconnect(self, peer: int, timeout: float = 10.0) -> None:
        return self.base.reconnect(peer, timeout)

    def close(self) -> None:
        self.base.close()
