"""Wave-pipelined MPC executor — the §4.4 schedule, executable.

The port of repro/core/executor.py on one device (`mesh="none"`). The
Stage-2 sieve's candidate batches are grouped into
waves of W:

  COALESCE   the share-level proxy forward is `torch.func.vmap`ped across
             the wave: the Python protocol runs once per wave with
             per-lane shapes, so every `comm.record` fires once and
             `comm.wave_scope(lanes)` scales it — rounds of latency-bound
             flights are paid per wave, bytes per batch. The kernels'
             vmap rules fold the lanes into their batch: one launch per
             wave.
  OVERLAP    waves are double-buffered: wave i+1 is dispatched before
             waiting on wave i. A wave is ready when a CUDA event
             recorded after its last kernel has completed; work is
             queued on torch's current stream, no extra stream.

Accounting is part of the execution contract: every flight lands in the
ambient Ledger, and the phase ledger must satisfy `iosched.ledger_agrees`
against the per-batch probe (engine/trace.py). Scores are bitwise
identical across the (coalesce, overlap) variants and bitwise equal to
the JAX package's for the same key.

`run_variants` executes Fig 7's four (coalesce, overlap) points on one
pool and holds them to that contract.

WIRE       with `ExecConfig.wire` "local" or "socket", every executed
           flight's actual messages are captured into a `comm.WireTape`
           (coalescing is forced off: a vmapped lane's payloads are
           abstract) and `finish` replays the tape as real parties
           (net/runtime.PartyRuntime): bytes reconciled against the
           phase ledger, payload digests checked, `wire_makespan_s`
           measured. `chaos_seed` derives a deterministic FaultPlan from
           the tape; `degraded` places its crash at the phase boundary
           for a 2-of-3 finish.

The executor runs on the card (`ExecConfig.device="cuda"`) unless the
caller asks for the CPU, as the tests do; asking for CUDA where there is
no card raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import iosched
from repro_torch.core import proxy as proxy_mod
from repro_torch.core.proxy import ProxySpec
from repro_torch.engine import MPCEngine, cached_probe, proxy_entropy
from repro_torch.engine.base import FULL_VARIANT
from repro_torch.kernels import ops as kops
from repro_torch import net
from repro_torch.mpc import comm, fusion, prng, protocols
from repro_torch.mpc.comm import DeviceReport, Ledger, NetProfile, WaveTiming
from repro_torch.net import faults
from repro_torch.mpc.ring import RING64, RingSpec
from repro_torch.mpc.sharing import Share, share


def resolve_device(device) -> torch.device:
    """The run's device; CUDA without a card raises (never falls back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ExecConfig asks for CUDA but no CUDA device is "
                           "available (pass device='cpu' for the CPU run)")
    return dev


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Runtime knobs for one executor — mirrors iosched.SchedConfig so a
    measured phase can be priced by the identical schedule."""
    wave: int = 8                 # batches coalesced per flight
    coalesce: bool = True
    overlap: bool = True
    batch: int = 64               # candidates per batch
    flops_per_s: float = 10e12
    ring: RingSpec = RING64
    # secret-sharing protocol backend (mpc/protocols/): "2pc" additive
    # with trusted-dealer triples, "3pc" replicated 2-of-3, dealer-free,
    # "spdz2pc" MAC'd malicious 2PC, "aby3trunc" 3pc with exact trunc2
    protocol: str = "2pc"
    # round compression (mpc/fusion.py): run each batch's forward under
    # a flight_scope so independent openings share flights
    fuse: bool = True
    # real-wire execution (net/): "none" keeps flights modeled; "local"
    # replays the captured flight tape as one thread per party over
    # in-process queues; "socket" spawns one PROCESS per party over paced
    # localhost TCP emulating `net`'s profile and measures wall-clock
    # (PhaseReport.wire). Wire capture needs concrete message tensors,
    # so the executor forces coalesce=False under wire modes — scores
    # are schedule-invariant (run_variants proves it bitwise).
    wire: str = "none"
    # which comm.PROFILES entry prices the model AND paces the socket
    net: str = "wan"
    # chaos (net/faults.py): with a seed, derive a deterministic
    # FaultPlan from the captured tape and replay under injected faults
    # (reliable delivery + crash recovery engage automatically); scores
    # must stay bitwise identical and goodput must still reconcile.
    chaos_seed: int | None = None
    # degraded 2-of-3: a 3PC party that dies at a phase boundary is
    # dropped and the survivors finish the opens (replicated sharing)
    degraded: bool = False
    mesh: str = "none"            # device mesh: not ported yet
    device: str = "cuda"

    def sched(self) -> iosched.SchedConfig:
        return iosched.SchedConfig(coalesce=self.coalesce,
                                   overlap=self.overlap,
                                   wave=max(1, self.wave),
                                   flops_per_s=self.flops_per_s)


@dataclasses.dataclass
class PhaseReport:
    """What one executed sieve phase put on the wire."""
    ledger: Ledger                # realized flights, whole phase
    per_batch: Ledger             # one batch's op stream (probe)
    n_batches: int
    n_waves: int
    wall_s: float
    sched: iosched.SchedConfig
    ring: RingSpec = RING64
    protocol: str = "2pc"
    fused: bool = True
    # real-wire outcome (net.WireReport) when the phase ran with
    # ExecConfig.wire != "none": measured wire_makespan_s, reconciled
    # byte counts, payload digests
    wire: net.WireReport | None = None
    # device-side outcome: per-wave dispatch/ready stamps and the
    # kernel launch counters for the phase
    device: DeviceReport | None = None

    @property
    def device_makespan_s(self) -> float:
        """Measured device-side makespan (first dispatch -> last wave
        ready)."""
        return self.device.device_makespan_s if self.device else 0.0

    def agrees(self) -> bool:
        """Realized flights == the makespan model's inputs, exactly."""
        return iosched.ledger_agrees(self.ledger, self.per_batch,
                                     self.n_batches, self.sched)

    def makespan(self, net: NetProfile) -> float:
        """Modeled end-to-end delay of this phase's measured op stream."""
        return iosched.makespan(self.per_batch, self.n_batches, net,
                                self.sched)

    def as_dict(self, net: NetProfile | None = None) -> dict:
        """The per-phase report dict, in the JAX package's shape:
        `makespan_wan_s` prices the measured stream under the WAN
        profile; pass `net` to price it under another comm.PROFILES
        entry too (adds `net` and `net_makespan_s`)."""
        d = {
            "n_batches": self.n_batches, "n_waves": self.n_waves,
            "protocol": self.protocol,
            "lat_rounds": self.ledger.lat_rounds,
            "bw_rounds": self.ledger.bw_rounds,
            "nbytes": self.ledger.nbytes,
            "offline_nbytes": self.ledger.offline_nbytes,
            "makespan_wan_s": self.makespan(comm.PROFILES["wan"]),
            "wall_s": self.wall_s,
            "device_makespan_s": self.device_makespan_s,
            "device": self.device.as_dict() if self.device is not None
                      else None,
            "wire": self.wire.as_dict() if self.wire is not None else None,
        }
        if net is not None and net.name != "wan":
            d["net"] = net.name
            d["net_makespan_s"] = self.makespan(net)
        return d


class WaveExecutor:
    """Runs the Stage-2 multiphase sieve through the §4.4 schedule."""

    def __init__(self, cfg: ExecConfig):
        if cfg.wire not in ("none", "local", "socket"):
            raise ValueError(f"unknown wire mode {cfg.wire!r}")
        if cfg.mesh != "none":
            raise NotImplementedError(f"mesh={cfg.mesh!r} is not ported yet")
        if cfg.chaos_seed is not None and cfg.wire == "none":
            raise ValueError("chaos_seed needs a real wire "
                             "(wire='local' or 'socket')")
        if cfg.wire != "none" and cfg.coalesce:
            # capturing real message tensors requires the eager per-lane
            # path (vmap abstracts the payloads away); the schedule is
            # score-invariant, so this changes WHEN flights happen, not
            # what they carry
            cfg = dataclasses.replace(cfg, coalesce=False)
        resolve_device(cfg.device)
        self.cfg = cfg
        self.reports: list[PhaseReport] = []

    def score_phase(self, key, pp, arch_cfg: ArchConfig, tokens,
                    spec: ProxySpec, variant=FULL_VARIANT) -> Share:
        """Encrypted entropy for every candidate, executed wave-by-wave.

        Identical numerics across all four (coalesce, overlap) variants:
        per-batch PRNG keys and share masks are assigned once, so the
        schedule changes only WHEN flights happen, never their contents.
        """
        run = PhaseRun(self.cfg, key, pp, arch_cfg, tokens, spec, variant)
        for wi in range(run.n_waves):
            run.dispatch(wi)
        run.drain()
        ent, rep = run.finish()
        self.reports.append(rep)
        return ent


def _ring_counts() -> dict:
    """The ring kernels' launch counters: secure_matmul's, ring_matmul's."""
    return {"smm": kops.smm_stats(), "rmm": kops.rmm_stats()}


class PhaseRun:
    """One sieve phase as a stepwise schedule:

      dispatch(wi)  share wave wi and run its forward under the per-wave
                    ledger scope, then wait for the PREVIOUS pending wave
                    (double-buffer discipline)
      drain()       wait for the tail pending wave
      finish()      concat scores, reconcile + replay the wire tape,
                    return (Share, PhaseReport)

    `WaveExecutor.score_phase` drives one run sequentially; the serve/
    appraisal server drives several at once, dispatching one session's
    wave while another's is in flight. So each run's flights go to its
    own `outer` ledger, and its kernel launches are counted around its
    own dispatches (not between construction and finish, which would
    also count the other sessions' launches).
    """

    def __init__(self, cfg: ExecConfig, key, pp, arch_cfg: ArchConfig,
                 tokens, spec: ProxySpec, variant=FULL_VARIANT,
                 outer: Ledger | None = None):
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        self.ring = ring = cfg.ring
        self.key = key = key.to(dev)
        self.pp = pp
        self.arch_cfg = arch_cfg
        self.spec = spec
        self.variant = variant
        B, W = cfg.batch, max(1, cfg.wave)
        self.B, self.W = B, W
        self.n = n = int(tokens.shape[0])
        self.seq = seq = int(tokens.shape[1])
        self.n_batches = n_batches = -(-n // B)
        self.n_waves = -(-n_batches // W)
        tok = np.asarray(tokens)
        full = n_batches * B
        if full > n:                                   # wrap-pad the tail,
            reps = -(-full // n)                       # tiling if B > n
            tok = np.concatenate([tok] * reps)[:full]
        self.tok = tok

        self.proto = proto = cfg.protocol
        self.n_parties = protocols.get(proto).n_parties
        self.dev = DeviceReport(placement=cfg.mesh, n_devices=1,
                                mesh_axes={})
        # record into `outer`, else the ambient ledger at CONSTRUCTION
        # time
        self.outer = comm.get_ledger() if outer is None else outer
        self.phase_led = Ledger()
        # --wire: capture every executed flight's actual messages; the
        # tape is sized by the WIRE party count (spdz2pc stacks 4 share
        # rows but runs 2 parties)
        self.tape = (comm.WireTape(protocols.get(proto).n_wire_parties)
                     if cfg.wire != "none" else None)
        self.scale = float(np.float32(arch_cfg.d_model ** 0.5))
        # the ring kernels' launches of this run's dispatches, summed
        self.launches = {n: dict.fromkeys(c, 0)
                         for n, c in _ring_counts().items()}
        self.results: list[torch.Tensor] = []
        self.pending: torch.cuda.Event | None = None
        self.pending_wi = -1

        self.pp_sh = proxy_mod.share_proxy(prng.fold_in(key, 1), pp, ring,
                                           proto)
        self.batch_keys = prng.split(prng.fold_in(key, 2), n_batches)
        # per-batch op-stream reference: the meta-tensor probe (fused
        # exactly like the executed forwards below), memoized on the
        # probe geometry
        self.per_batch = cached_probe(
            arch_cfg, spec, batch=B, seq=seq,
            classes=int(pp["cls_head"].shape[-1]), ring=ring,
            protocol=proto, fused=cfg.fuse, variant=variant)
        self.t0 = time.time()

    def lanes(self, wi: int) -> int:
        """Batches in wave `wi` (the last wave may be short)."""
        b0, b1 = wi * self.W, min((wi + 1) * self.W, self.n_batches)
        return b1 - b0

    def _fwd(self, sh, k):
        eng = MPCEngine(ring=self.ring, protocol=self.proto).with_key(k)
        with fusion.flight_scope(enabled=self.cfg.fuse):
            return proxy_entropy(eng, self.pp_sh, self.arch_cfg,
                                 Share(sh, self.ring, self.proto),
                                 self.spec, self.variant).sh

    def _ready(self):
        """A marker that the work queued so far has finished."""
        if self.device.type != "cuda":
            return None                # CPU ops complete when they return
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _wait(self, ev, wi: int) -> None:
        if ev is not None:
            ev.synchronize()
        self.dev.waves[wi].ready_s = time.time() - self.t0

    def dispatch(self, wi: int) -> None:
        """Run wave `wi` and leave it in flight (cfg.overlap) — waiting
        for the previously pending wave only after this one is
        dispatched."""
        cfg = self.cfg
        B, W, seq = self.B, self.W, self.seq
        b0 = wi * W
        lanes = self.lanes(wi)
        b1 = b0 + lanes
        before = _ring_counts()
        wave_tok = torch.as_tensor(self.tok[b0 * B:b1 * B]).to(
            self.device).reshape(lanes, B, seq)
        x = self.pp["embed"][wave_tok] * self.scale
        x_sh = share(prng.fold_in(self.key, 100 + wi), x.to(torch.float32),
                     self.ring, self.proto)
        w_start = time.time() - self.t0
        keys = self.batch_keys[b0:b1]

        with comm.ledger_scope() as wave_led, \
                comm.wire_tape_scope(self.tape):
            if cfg.coalesce:
                vf = torch.func.vmap(self._fwd, in_dims=(1, 0), out_dims=1)
                with comm.wave_scope(lanes):
                    ent = vf(x_sh.sh, keys)
            else:
                ent = torch.stack([self._fwd(x_sh.sh[:, li], keys[li])
                                   for li in range(lanes)], dim=1)
        for n, after in _ring_counts().items():
            for k, v in after.items():
                self.launches[n][k] += v - before[n][k]
        self.phase_led.records.extend(wave_led.records)
        if self.outer is not None:
            self.outer.records.extend(wave_led.records)

        ent = ent.reshape(self.n_parties, lanes * B)
        self.dev.waves.append(WaveTiming(
            wave=wi, lanes=lanes, devices_used=1, start_s=w_start,
            dispatch_s=time.time() - self.t0))
        ready = self._ready()
        # double buffer: wait for wave i-1 only after dispatching i
        if self.pending_wi >= 0:
            self._wait(self.pending, self.pending_wi)
            self.pending, self.pending_wi = None, -1
        if cfg.overlap:
            self.pending, self.pending_wi = ready, wi
        else:
            self._wait(ready, wi)
        self.results.append(ent)

    def drain(self) -> None:
        """Wait for the tail pending wave (the loop's final barrier)."""
        if self.pending_wi >= 0:
            self._wait(self.pending, self.pending_wi)
            self.pending, self.pending_wi = None, -1

    def finish(self) -> tuple[Share, PhaseReport]:
        """Concatenate scores, reconcile/replay the wire tape, and seal
        the PhaseReport. Call after every wave is dispatched and
        drain()."""
        cfg = self.cfg
        out = torch.cat(self.results, dim=1)[:, :self.n]
        wall_s = time.time() - self.t0
        smm, rmm = self.launches["smm"], self.launches["rmm"]
        dev = self.dev
        dev.combine_kernel = smm["kernel"]
        dev.combine_ref = smm["ref"]
        dev.combine_padded = smm["padded"]
        dev.matmul_kernel = rmm["kernel"]
        dev.matmul_ref = rmm["ref"]
        wire_rep = None
        if self.tape is not None:
            # replay the captured flight plan as real parties: reconcile
            # record-for-record against the phase ledger, then measure
            net.reconcile(self.phase_led, self.tape)
            fault_plan = None
            if cfg.chaos_seed is not None:
                fault_plan = faults.FaultPlan.from_tape(
                    cfg.chaos_seed, self.tape,
                    crash_at_boundary=cfg.degraded)
            wire_rep = net.PartyRuntime(
                self.tape, mode=cfg.wire,
                profile=(comm.PROFILES[cfg.net] if cfg.wire == "socket"
                         else None),
                fault_plan=fault_plan,
                recover=fault_plan is not None and not cfg.degraded,
                degraded=cfg.degraded).execute()
        rep = PhaseReport(
            ledger=self.phase_led, per_batch=self.per_batch,
            n_batches=self.n_batches, n_waves=self.n_waves, wall_s=wall_s,
            sched=cfg.sched(), ring=self.ring, protocol=self.proto,
            fused=cfg.fuse, wire=wire_rep, device=dev)
        return Share(out, self.ring, self.proto), rep


def run_variants(key, pp, arch_cfg: ArchConfig, tokens, spec: ProxySpec,
                 *, batch: int, wave: int,
                 flops_per_s: float = 10e12,
                 fuse: bool | None = None,
                 protocol: str = "2pc", ring: RingSpec = RING64,
                 variant=FULL_VARIANT,
                 device: str = "cuda") -> dict[str, PhaseReport]:
    """Fig-7's four (coalesce, overlap) points, executed on one pool.

    Returns name -> PhaseReport; every variant is checked for exact
    ledger agreement with the makespan inputs, and all variants produce
    bitwise-identical scores (the schedule moves flights, not values —
    and the flight batcher, on by default, `fuse=None` following
    ExecConfig, compresses rounds without changing a share either).
    """
    reports = {}
    ref = None
    fuse_kw = {} if fuse is None else {"fuse": fuse}
    for name, (co, ov) in iosched.FIG7_VARIANTS.items():
        ex = WaveExecutor(ExecConfig(wave=wave, coalesce=co, overlap=ov,
                                     batch=batch, flops_per_s=flops_per_s,
                                     protocol=protocol, ring=ring,
                                     device=device, **fuse_kw))
        ent = ex.score_phase(key, pp, arch_cfg, tokens, spec, variant)
        rep = ex.reports[-1]
        if not rep.agrees():
            raise AssertionError(
                f"executor ledger for {name} diverges from makespan inputs")
        if ref is None:
            ref = ent.sh
        elif not torch.equal(ref, ent.sh):
            raise AssertionError(f"variant {name} changed scores")
        reports[name] = rep
    return reports
