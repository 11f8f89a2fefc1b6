"""PartyRuntime: execute a captured flight plan as real parties — the
port of repro/net/runtime.py.

The MPC engine computes every party's share components in one process
(the simulation layout of mpc/sharing.py) while `comm.WireTape` captures
each online flight's actual point-to-point messages. This module closes
the loop: it compiles the tape into one flight plan PER PARTY and runs
one worker per party — threads over a `LocalTransport` (`mode="local"`,
deterministic) or spawned processes over `SocketTransport` meshes
(`mode="socket"`, paced + latency-injected localhost TCP) — so every
recorded flight becomes an actual framed exchange.

What executing the plan proves, per run:

  bytes    transport-counted GOODPUT bytes == the tape's (== the
           ledger's) `nbytes`, link by link — `reconcile()` and the
           post-run check both fail loudly on divergence. Chaos
           recovery traffic (retransmissions, ACKs) is counted on a
           separate RETRANS channel and never bends this match;
  content  each party chain-digests every payload it receives, in
           order (state = BLAKE2b(state || payload)); the final states
           must match what the tape says it should receive. The chain
           form makes the digest CHECKPOINTABLE — a crashed party
           resumes it from its flight cursor;
  time     `wire_makespan_s` is measured wall-clock between the SYNC
           start barrier and the last party finishing.

Fault tolerance (opt-in, `reliable=True` / `fault_plan=` / `recover=`):

  * `transport.ReliableTransport` gives every link sequenced,
    deduplicated, retransmitting delivery — dropped frames and
    connection resets (injected by `faults.ChaosTransport` or real)
    heal under the flight plan without changing its semantics.
  * every party commits a durable flight cursor (atomic write +
    COMMIT file, the `checkpoint/ckpt.py` discipline) after each
    flight, then cumulatively ACKs — peers prune their resend buffers
    only up to committed state, so anything a crashed party may need
    again is still buffered somewhere.
  * a supervisor watches socket-mode children: a dead process (or a
    live one whose cursor stops advancing past the heartbeat window —
    the `ft.HeartbeatMonitor` escalation path) is declared dead and
    respawned; the new incarnation restores its cursor (flight index,
    digest chain state, per-link sequence/goodput watermarks), skips
    the start barrier, reconnects the mesh and replays from its last
    committed flight. Re-sent flights dedup at the receivers;
    re-counted bytes land in goodput exactly once across incarnations.
  * degraded mode (`degraded=True`, 3-party tapes): a party dead at a
    phase boundary (nothing committed) is dropped instead of
    respawned — survivors rerun the tape filtered of the dead party's
    links, completing 2-of-3, and the report says so.

Liveness rides along: workers emit BEAT frames to party 0 every
`beat_every` flights and party 0 drains them into a
`runtime.ft.HeartbeatMonitor` (via `ft.TransportHeartbeat`), so the
fault-tolerance heartbeat path is exercised by the same wire as the
protocol traffic.

Deadlock-freedom: every party walks the SAME tape in the same flight
order, sends are non-blocking enqueues, and multi-sub-round flights
(comparisons, ABY3 trunc2) order their dependent messages via the
WireMsg `rnd` field — a party never blocks on a message whose sender
has not already been able to enqueue it.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import multiprocessing
import os
import tempfile
import threading
import time
import zlib

from repro_torch.net import faults as fx
from repro_torch.net import transport as tp
from repro_torch.runtime import ft

# flights between BEAT frames (and beat-queue drains on party 0)
DEFAULT_BEAT_EVERY = 8
# socket-mode exit code for an injected hard crash (os._exit)
CRASH_EXIT = 77
MAX_RESPAWNS = 2


# ---------------------------------------------------------------------------
# plan compilation — tape -> per-party send/recv schedule
# ---------------------------------------------------------------------------
# A plan is pickle-plain (lists/tuples/bytes/ints) because socket-mode
# children receive theirs through multiprocessing spawn args:
#   plan   = [flight, ...]
#   flight = [(sends, recvs), ...]      one entry per sub-round, in order
#   sends  = [(dst, payload_bytes), ...]
#   recvs  = [(src, expected_nbytes), ...]

def compile_plan(tape, party: int) -> list:
    plan = []
    for f in tape.flights:
        rounds = sorted({m.rnd for m in f.msgs}) or [0]
        subs = []
        for r in rounds:
            sends = [(m.dst, m.data) for m in f.msgs
                     if m.rnd == r and m.src == party]
            recvs = [(m.src, len(m.data)) for m in f.msgs
                     if m.rnd == r and m.dst == party]
            subs.append((sends, recvs))
        plan.append(subs)
    return plan


def _chain(state: bytes, payload: bytes) -> bytes:
    return hashlib.blake2b(state + payload, digest_size=16).digest()


def expected_digests(tape, n_parties: int) -> list[str]:
    """Per-party chained BLAKE2b over every payload the party receives,
    in the order the party loop receives them — the content half of the
    reconciliation contract. Chained (state = H(state || payload))
    rather than streamed so a party's digest state is a 16-byte value
    that checkpoints into the flight cursor and survives a crash."""
    states = [b"" for _ in range(n_parties)]
    for f in tape.flights:
        for r in sorted({m.rnd for m in f.msgs} or {0}):
            for m in f.msgs:
                if m.rnd == r:
                    states[m.dst] = _chain(states[m.dst], m.data)
    return [s.hex() for s in states]


def filter_tape(tape, dead: int):
    """The degraded 2-of-3 tape: every message to or from the dead
    party removed, flight structure (count, ops, sub-rounds) intact.
    Surviving parties replay THIS tape; byte/digest reconciliation
    holds against its totals."""
    t2 = copy.copy(tape)
    t2.flights = []
    for f in tape.flights:
        kept = tuple(m for m in f.msgs if dead not in (m.src, m.dst))
        t2.flights.append(dataclasses.replace(
            f, msgs=kept, nbytes=sum(len(m.data) for m in kept)))
    return t2


# ---------------------------------------------------------------------------
# durable flight cursor — the crash-recovery resume point
# ---------------------------------------------------------------------------

class FlightCursor:
    """Per-party durable replay position, `checkpoint/ckpt.py`
    discipline: the state file is written to a tmp name and atomically
    renamed, then the COMMIT marker (naming the flight) is renamed into
    place LAST — a crash between the two leaves the previous commit
    authoritative. The payload carries a crc32 so a torn write is
    detected and the newest intact older cursor wins."""

    KEEP = 3   # retained cursor generations

    def __init__(self, run_dir: str, party: int):
        self.dir = os.path.join(run_dir, f"party{party}")
        os.makedirs(self.dir, exist_ok=True)
        self._commit_path = os.path.join(self.dir, "COMMIT")

    def _cursor_path(self, flight: int) -> str:
        return os.path.join(self.dir, f"cursor-{flight:08d}.json")

    def commit(self, flight: int, digest_state: bytes,
               wire_state: dict | None) -> None:
        body = json.dumps({"flight": flight,
                           "digest_state": digest_state.hex(),
                           "wire": wire_state or {}},
                          sort_keys=True)
        payload = json.dumps({"crc": zlib.crc32(body.encode()),
                              "body": body})
        path = self._cursor_path(flight)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = self._commit_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(flight))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._commit_path)
        self._prune(flight)

    def _prune(self, newest: int) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("cursor-") and name.endswith(".json"):
                try:
                    n = int(name[7:15])
                except ValueError:
                    continue
                if n <= newest - self.KEEP:
                    try:
                        os.remove(os.path.join(self.dir, name))
                    except OSError:
                        pass

    def _read(self, flight: int) -> dict | None:
        try:
            with open(self._cursor_path(flight)) as f:
                raw = json.loads(f.read())
            if zlib.crc32(raw["body"].encode()) != raw["crc"]:
                return None                     # torn/corrupt write
            st = json.loads(raw["body"])
            st["digest_state"] = bytes.fromhex(st["digest_state"])
            return st
        except (OSError, ValueError, KeyError):
            return None

    def load(self) -> dict | None:
        """Newest committed state, falling back through retained older
        generations when the committed file is corrupt; None when
        nothing has ever committed."""
        try:
            with open(self._commit_path) as f:
                newest = int(f.read().strip())
        except (OSError, ValueError):
            return None
        for flight in range(newest, max(0, newest - self.KEEP), -1):
            st = self._read(flight)
            if st is not None:
                return st
        return None

    def committed_flight(self) -> int:
        st = self.load()
        return st["flight"] if st else 0

    def mtime(self) -> float | None:
        """COMMIT file mtime — the supervisor's liveness signal: a
        party whose cursor stops advancing is a heartbeat suspect."""
        try:
            return os.path.getmtime(self._commit_path)
        except OSError:
            return None


# ---------------------------------------------------------------------------
# the party loop (shared by thread and process workers)
# ---------------------------------------------------------------------------

def _sync_barrier(t, party: int, n: int, timeout: float,
                  active: list | None = None):
    """All-parties gate rooted at the lowest active party: workers
    report in, the root releases everyone. Used at the start (timing
    begins only after release, so connection setup never pollutes the
    makespan) and at the end (nobody tears its mesh down while a peer
    is still replaying — link death is LOUD now, so an early close
    would read as a fault)."""
    active = list(active) if active is not None else list(range(n))
    root = min(active)

    def _send(dst):
        try:
            t.send(party, dst, b"", kind=tp.SYNC)
        except tp.WireDown:
            # a link that died late (post-last-DATA reset) and nothing
            # recovered yet: heal it here, the barrier must hold
            t.reconnect(dst, timeout=min(timeout, 5.0))
            t.send(party, dst, b"", kind=tp.SYNC)

    def _recv(src):
        try:
            t.recv(party, src, kind=tp.SYNC, timeout=timeout)
        except tp.WireDown:
            t.reconnect(src, timeout=min(timeout, 5.0))
            t.recv(party, src, kind=tp.SYNC, timeout=timeout)

    if party == root:
        for p in active:
            if p != root:
                _recv(p)
        for p in active:
            if p != root:
                _send(p)
    else:
        _send(root)
        _recv(root)


def _beat(hb) -> None:
    # heartbeats are advisory: a down link must never kill the worker
    try:
        hb.emit()
        hb.drain()
    except tp.WireError:
        pass


def _party_loop(t, party: int, n: int, plan: list,
                beat_every: int, timeout: float,
                heartbeat_timeout_s: float, *,
                rt: tp.ReliableTransport | None = None,
                fault_plan: fx.FaultPlan | None = None,
                cursor: FlightCursor | None = None,
                resume: bool = False,
                hard_crash: bool = False,
                active: list | None = None) -> dict:
    act = list(active) if active is not None else list(range(n))
    hb = ft.TransportHeartbeat(
        t, party, n,
        monitor=(ft.HeartbeatMonitor(n, timeout_s=heartbeat_timeout_s)
                 if party == 0 else None),
        kind=tp.BEAT)
    state = b""
    start_flight = 0
    if resume and cursor is not None:
        st = cursor.load()
        if st is not None:
            start_flight = st["flight"]
            state = st["digest_state"]
            if rt is not None:
                rt.restore_for(party, st["wire"])
                # rebuild the resend window from the tape: a peer may
                # still be missing a pre-crash frame (e.g. one a reset
                # ate just before we died) and will ask for it by seq
                seqs: dict[int, int] = {}
                for j in range(start_flight):
                    for sends, _recvs in plan[j]:
                        for dst, data in sends:
                            s = seqs.get(dst, 0)
                            rt.rebuffer(party, dst, s, data)
                            seqs[dst] = s + 1
    if not resume:
        _sync_barrier(t, party, n, timeout, act)
    t0 = time.monotonic()
    for i in range(start_flight, len(plan)):
        if fault_plan is not None and fault_plan.crash == (party, i):
            if hard_crash:
                os._exit(CRASH_EXIT)     # a real death, not an exception
            raise fx.InjectedCrash(f"party {party} crashed at flight {i}")
        stall = fault_plan.slow.get(party) if fault_plan is not None else None
        if stall:
            time.sleep(stall)
        for sends, recvs in plan[i]:
            for dst, data in sends:
                t.send(party, dst, data)
            for src, want in recvs:
                data = t.recv(party, src, timeout=timeout)
                if len(data) != want:
                    raise tp.WireError(
                        f"party {party} flight {i}: expected {want} bytes "
                        f"from {src}, got {len(data)}")
                state = _chain(state, data)
        if cursor is not None:
            # durable BEFORE the cumulative ACK: peers prune their
            # resend buffers only past what we can never need again
            cursor.commit(i + 1, state,
                          rt.state_for(party) if rt is not None else None)
        if rt is not None:
            rt.ack(party)
        if beat_every and (i + 1) % beat_every == 0:
            _beat(hb)
    _beat(hb)
    t1 = time.monotonic()
    _sync_barrier(t, party, n, timeout, act)    # end gate: see docstring
    sent = {link: nb for link, nb in t.data_bytes.items()
            if link[0] == party}
    res = {"party": party, "t0": t0, "t1": t1,
           "elapsed_s": t1 - t0, "digest": state.hex(),
           "sent_bytes": sent, "resumed": resume,
           "beats_seen": hb.beats_seen,
           "suspects": hb.monitor.suspects() if hb.monitor else []}
    if rt is not None:
        res["wire_stats"] = {
            "retries": rt.retries, "dup_frames": rt.dup_frames,
            "gap_frames": rt.gap_frames, "reconnects": rt.reconnects,
            "recovery_s": rt.recovery_s,
            "retrans_bytes": sum(rt.retrans_bytes.values())
            if hasattr(rt.retrans_bytes, "values") else 0,
            "ack_bytes": rt.ack_bytes}
    return res


def _build_stack(base, fault_plan, reliable):
    """base -> [ChaosTransport] -> [ReliableTransport]; chaos sits
    UNDER reliability so recovery sees injected faults exactly like
    real ones."""
    t = base
    chaos = None
    if fault_plan is not None:
        t = chaos = fx.ChaosTransport(t, fault_plan)
    rt = None
    if reliable:
        t = rt = tp.ReliableTransport(t)
    return t, chaos, rt


def _party_main(party: int, n: int, ports: list, profile, plan: list,
                beat_every: int, timeout: float, heartbeat_timeout_s: float,
                q, fault_plan=None, reliable: bool = False,
                run_dir: str | None = None, resume: bool = False,
                absent: tuple = ()) -> None:
    """Socket-mode child entry point (module-level: spawn imports it by
    reference — `repro_torch.net.runtime._party_main`)."""
    base = tp.SocketTransport(n, party, ports, profile,
                              connect_timeout=timeout, absent=absent)
    t, _chaos_t, rt = _build_stack(base, fault_plan, reliable)
    cursor = FlightCursor(run_dir, party) if run_dir else None
    try:
        res = _party_loop(t, party, n, plan, beat_every, timeout,
                          heartbeat_timeout_s, rt=rt,
                          fault_plan=fault_plan, cursor=cursor,
                          resume=resume, hard_crash=True,
                          active=[p for p in range(n) if p not in absent])
        res["n_frames"] = base.n_frames
        q.put(res)
    except BaseException as e:                     # surface to the parent
        q.put({"party": party, "error": f"{type(e).__name__}: {e}"})
        raise
    finally:
        t.close()


# ---------------------------------------------------------------------------
# reconciliation + report
# ---------------------------------------------------------------------------

def reconcile(ledger, tape) -> dict:
    """Record-for-record check that the captured flight plan IS the
    ledger's online cost model: same flight count, same op / rounds /
    nbytes per flight, message sizes summing to each flight's nbytes.
    Raises WireError on any divergence; returns a summary dict."""
    online = [r for r in ledger.records if r.tag != "offline"]
    if len(online) != len(tape.flights):
        raise tp.WireError(
            f"ledger has {len(online)} online records but the tape "
            f"captured {len(tape.flights)} flights")
    for i, (r, f) in enumerate(zip(online, tape.flights)):
        if (r.op, r.rounds, r.nbytes) != (f.op, f.rounds, f.nbytes):
            raise tp.WireError(
                f"flight {i} diverges: ledger ({r.op}, rounds={r.rounds}, "
                f"nbytes={r.nbytes}) vs tape ({f.op}, rounds={f.rounds}, "
                f"nbytes={f.nbytes})")
        msg_total = sum(len(m.data) for m in f.msgs)
        if msg_total != f.nbytes:
            raise tp.WireError(
                f"flight {i} ({f.op}): messages carry {msg_total} bytes, "
                f"record prices {f.nbytes}")
    return {"n_flights": len(online), "nbytes": tape.nbytes}


@dataclasses.dataclass
class WireReport:
    """Outcome of one real-wire execution of a tape."""
    mode: str                       # "local" | "socket"
    n_parties: int
    n_flights: int
    n_msgs: int
    tape_nbytes: int                # what the ledger/tape priced
    wire_nbytes: int                # GOODPUT the transport counted
    wire_makespan_s: float          # measured: barrier -> last party done
    per_party_s: list
    digests_ok: bool
    n_frames: int
    beats_seen: int = 0
    suspects: list = dataclasses.field(default_factory=list)
    # chaos / recovery accounting (the RETRANS channel — never part of
    # the goodput `bytes_match` contract)
    retries: int = 0                # timeout-triggered resend requests
    retrans_bytes: int = 0          # retransmitted DATA payload bytes
    ack_bytes: int = 0              # ACK control payload bytes
    dup_frames: int = 0             # retransmissions deduplicated
    reconnects: int = 0             # TCP link re-establishments
    respawns: int = 0               # party processes respawned
    recovery_time_s: float = 0.0    # death detection -> resumed replay
    faults_injected: int = 0
    degraded: bool = False          # 2-of-3 completion
    dead_parties: list = dataclasses.field(default_factory=list)
    fault_plan: str | None = None   # the injected FaultPlan, as JSON

    @property
    def bytes_match(self) -> bool:
        return self.wire_nbytes == self.tape_nbytes

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bytes_match"] = self.bytes_match
        return d


class _DegradedRestart(Exception):
    """Internal supervisor signal: drop `dead` and rerun 2-of-3."""

    def __init__(self, dead: int):
        self.dead = dead
        super().__init__(f"party {dead} dead at phase boundary")


class PartyRuntime:
    """Run a `comm.WireTape` as real parties over a transport.

    mode="local"   one thread per party over a shared LocalTransport —
                   deterministic, unpaced; the correctness path.
    mode="socket"  one spawned process per party over a SocketTransport
                   mesh, paced/delayed by `profile` — the measurement
                   path.

    Fault tolerance knobs:
      reliable    wrap every party's transport in ReliableTransport
                  (sequencing + dedup + resend + reconnect).
      fault_plan  a `faults.FaultPlan` to inject (forces reliable).
      recover     respawn crashed parties and resume from their durable
                  flight cursor.
      degraded    3-party tapes only: a party dead at a phase boundary
                  (nothing committed) is dropped and survivors complete
                  2-of-3 over the filtered tape.
      run_dir     where flight cursors live (a fresh tempdir when
                  recovery is on and no directory is given).
    """

    def __init__(self, tape, mode: str = "local", profile=None,
                 beat_every: int = DEFAULT_BEAT_EVERY,
                 timeout_s: float = 60.0,
                 heartbeat_timeout_s: float = 30.0,
                 reliable: bool = False,
                 fault_plan: fx.FaultPlan | None = None,
                 recover: bool = False,
                 degraded: bool = False,
                 run_dir: str | None = None):
        if mode not in ("local", "socket"):
            raise ValueError(f"unknown wire mode {mode!r}")
        self.tape = tape
        self.mode = mode
        self.profile = profile
        self.beat_every = beat_every
        self.timeout_s = timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.fault_plan = fault_plan
        self.reliable = reliable or fault_plan is not None
        self.recover = recover
        self.degraded = degraded
        if fault_plan is not None and fault_plan.crash is not None \
                and not (recover or degraded):
            raise ValueError(
                "a FaultPlan with a crash needs recover=True (respawn) "
                "or degraded=True (2-of-3)")
        if (recover or fault_plan is not None) and run_dir is None:
            run_dir = tempfile.mkdtemp(prefix="wire-cursor-")
        self.run_dir = run_dir

    def execute(self) -> WireReport:
        try:
            return self._execute(self.tape, active=None,
                                 fault_plan=self.fault_plan,
                                 run_dir=self.run_dir)
        except _DegradedRestart as d:
            # 2-of-3 completion: drop the dead party, replay the
            # filtered tape among survivors (fresh mesh, same faults
            # minus the crash). The replay keeps its cursors in a
            # directory of its own: a first-attempt survivor thread may
            # still be committing a cursor of the same party and flight
            # (the JAX package shares the directory and races on it)
            n = self.tape.n_parties
            survivors = [p for p in range(n) if p != d.dead]
            plan = (self.fault_plan.without_crash()
                    if self.fault_plan is not None else None)
            run_dir = (os.path.join(self.run_dir, "degraded")
                       if self.run_dir else None)
            rep = self._execute(filter_tape(self.tape, d.dead),
                                active=survivors, fault_plan=plan,
                                run_dir=run_dir)
            rep.degraded = True
            rep.dead_parties = [d.dead]
            return rep

    def _execute(self, tape, active: list | None,
                 fault_plan: fx.FaultPlan | None,
                 run_dir: str | None) -> WireReport:
        n = tape.n_parties
        act = active if active is not None else list(range(n))
        plans = [compile_plan(tape, p) for p in range(n)]
        want_digests = expected_digests(tape, n)
        if self.mode == "local":
            results, n_frames, stats = self._run_local(
                plans, n, act, fault_plan, run_dir)
        else:
            results, n_frames, stats = self._run_socket(
                plans, n, act, fault_plan, run_dir)
        results.sort(key=lambda r: r["party"])
        wire_nbytes = sum(nb for r in results
                          for nb in r["sent_bytes"].values())
        digests_ok = all(r["digest"] == want_digests[r["party"]]
                         for r in results)
        # CLOCK_MONOTONIC is boot-anchored on Linux, so t0/t1 are
        # comparable across the spawned party processes
        makespan = (max(r["t1"] for r in results)
                    - min(r["t0"] for r in results))
        report = WireReport(
            mode=self.mode, n_parties=n,
            n_flights=len(tape.flights),
            n_msgs=sum(len(f.msgs) for f in tape.flights),
            tape_nbytes=tape.nbytes, wire_nbytes=wire_nbytes,
            wire_makespan_s=makespan,
            per_party_s=[r["elapsed_s"] for r in results],
            digests_ok=digests_ok, n_frames=n_frames,
            beats_seen=sum(r["beats_seen"] for r in results),
            suspects=sorted({s for r in results for s in r["suspects"]}),
            faults_injected=fault_plan.n_faults if fault_plan else 0,
            fault_plan=fault_plan.to_json() if fault_plan else None,
            **stats)
        if not report.bytes_match:
            raise tp.WireError(
                f"wire counted {report.wire_nbytes} goodput bytes but "
                f"the tape priced {report.tape_nbytes}")
        if not digests_ok:
            raise tp.WireError(
                "received payload digests diverge from the tape — the "
                "wire did not carry the protocol's bytes")
        return report

    # -- backends -------------------------------------------------------
    def _run_local(self, plans: list, n: int, act: list, fault_plan,
                   run_dir: str | None):
        base = tp.LocalTransport(n)
        t, chaos, rt = _build_stack(base, fault_plan, self.reliable)
        cursors = {p: FlightCursor(run_dir, p) for p in act} \
            if run_dir else {}
        results: list = [None] * n
        errors: list = []
        crashes: list = []
        stats = {"respawns": 0, "recovery_time_s": 0.0}

        def work(p, resume=False):
            # a respawned incarnation keeps every link fault armed but
            # must not die twice
            fp = fault_plan.without_crash() if (resume and fault_plan) \
                else fault_plan
            try:
                results[p] = _party_loop(
                    t, p, n, plans[p], self.beat_every, self.timeout_s,
                    self.heartbeat_timeout_s, rt=rt, fault_plan=fp,
                    cursor=cursors.get(p), resume=resume, active=act)
            except fx.InjectedCrash:
                crashes.append((p, time.monotonic()))
            except BaseException as e:
                errors.append((p, e))

        threads = {p: threading.Thread(target=work, args=(p,), daemon=True)
                   for p in act}
        for th in threads.values():
            th.start()
        deadline = time.monotonic() + self.timeout_s * 2
        while any(th.is_alive() for th in threads.values()) or crashes:
            if crashes:
                p, t_dead = crashes.pop()
                committed = cursors[p].committed_flight() if cursors else 0
                if self.degraded and n == 3 and committed == 0:
                    raise _DegradedRestart(p)
                if not self.recover:
                    raise tp.WireError(
                        f"party {p} crashed and recovery is off")
                stats["respawns"] += 1
                stats["recovery_time_s"] += time.monotonic() - t_dead
                th = threading.Thread(target=work, args=(p, True),
                                      daemon=True)
                threads[p] = th
                th.start()
            if errors:
                break
            if time.monotonic() > deadline:
                raise tp.WireError("party threads never finished")
            time.sleep(0.01)
        for th in threads.values():
            th.join(timeout=self.timeout_s)
        if errors:
            p, e = errors[0]
            raise tp.WireError(f"party {p} failed: {e}") from e
        results = [r for r in results if r is not None]
        if len(results) != len(act):
            raise tp.WireError("a party thread never finished")
        if rt is not None:
            stats.update(retries=rt.retries, dup_frames=rt.dup_frames,
                         reconnects=rt.reconnects,
                         retrans_bytes=base.total_retrans_bytes,
                         ack_bytes=base.ack_bytes)
            stats["recovery_time_s"] += rt.recovery_s
        return results, base.n_frames, stats

    def _run_socket(self, plans: list, n: int, act: list, fault_plan,
                    run_dir: str | None):
        profile = (tp.LinkProfile(self.profile.bandwidth_Bps,
                                  self.profile.latency_s)
                   if self.profile is not None else None)
        ports = tp.free_ports(n)
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        absent = tuple(p for p in range(n) if p not in act)
        cursors = {p: FlightCursor(run_dir, p) for p in act} \
            if run_dir else {}
        stats = {"respawns": 0, "recovery_time_s": 0.0}

        def spawn(p, resume):
            plan = fault_plan.without_crash() if (resume and fault_plan) \
                else fault_plan
            pr = ctx.Process(
                target=_party_main,
                args=(p, n, ports, profile, plans[p], self.beat_every,
                      self.timeout_s, self.heartbeat_timeout_s, q,
                      plan, self.reliable, run_dir, resume, absent),
                daemon=True)
            pr.start()
            return pr

        procs = {p: spawn(p, False) for p in act}
        respawn_count = {p: 0 for p in act}
        # the supervisor's liveness monitor: a party beats by advancing
        # its durable cursor; a stalled-but-alive party becomes a
        # suspect and is escalated to declared-dead exactly like a
        # crashed one
        monitor = ft.HeartbeatMonitor(n, timeout_s=self.heartbeat_timeout_s)
        last_mtime = dict.fromkeys(act)
        results = []
        try:
            deadline = time.monotonic() + self.timeout_s * 4
            while len(results) < len(act):
                try:
                    res = q.get(timeout=0.2)
                except Exception:
                    res = None
                if res is not None:
                    if "error" in res:
                        raise tp.WireError(
                            f"party {res['party']} failed: {res['error']}")
                    results.append(res)
                    monitor.beat(res["party"])
                    continue
                done = {r["party"] for r in results}
                for p in act:
                    if p in done:
                        monitor.beat(p)
                        continue
                    if cursors:
                        mt = cursors[p].mtime()
                        if mt is not None and mt != last_mtime[p]:
                            last_mtime[p] = mt
                            monitor.beat(p)
                    pr = procs[p]
                    dead = (not pr.is_alive()
                            and pr.exitcode not in (0, None))
                    stalled = pr.is_alive() and p in monitor.suspects()
                    if not dead and not stalled:
                        continue
                    t_dead = time.monotonic()
                    if stalled:
                        # HeartbeatMonitor suspect -> declared dead
                        pr.terminate()
                        pr.join(timeout=5.0)
                    committed = cursors[p].committed_flight() \
                        if cursors else 0
                    if self.degraded and n == 3 and committed == 0:
                        raise _DegradedRestart(p)
                    if not self.recover \
                            or respawn_count[p] >= MAX_RESPAWNS:
                        raise tp.WireError(
                            f"party {p} died (exit {pr.exitcode}, "
                            f"{respawn_count[p]} respawns) and cannot "
                            "be recovered")
                    respawn_count[p] += 1
                    stats["respawns"] += 1
                    procs[p] = spawn(p, True)
                    monitor.beat(p)
                    stats["recovery_time_s"] += time.monotonic() - t_dead
                if time.monotonic() > deadline:
                    raise tp.WireError(
                        "timed out waiting for party results (alive: "
                        f"{[procs[p].is_alive() for p in act]})")
        except _DegradedRestart:
            for pr in procs.values():
                if pr.is_alive():
                    pr.terminate()
            raise
        finally:
            for pr in procs.values():
                pr.join(timeout=5.0)
                if pr.is_alive():
                    pr.terminate()
        n_frames = sum(r.get("n_frames", 0) for r in results)
        for r in results:
            ws = r.get("wire_stats")
            if ws:
                for k in ("retries", "dup_frames", "reconnects",
                          "retrans_bytes", "ack_bytes"):
                    stats[k] = stats.get(k, 0) + ws[k]
                stats["recovery_time_s"] += ws["recovery_s"]
        return results, n_frames, stats
