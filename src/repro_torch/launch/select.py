"""SelectFormer workflow launcher — the paper's end-to-end pipeline, the
port of repro/launch/select.py and the counterpart of
examples/private_selection.py.

    python -m repro_torch.launch.select --mode mpc --ring 32
    python -m repro_torch.launch.select --mode mpc --ring 32 --device cpu

Stage 1 bootstrap -> proxy generation -> Stage 2 multi-phase MPC sieve ->
Stage 3 transaction + appraisal -> finetune target on purchased data ->
report test accuracy and the modeled selection delay (WAN profile at
paper scale; pod-DCN profile for the deployment projection).

CPU-scale geometry by default (the tiny target + synthetic imbalanced
task of the JAX launcher), run on the card unless `--device cpu`. The
target is random from `--seed` through a torch.Generator, so its
weights are not the JAX launcher's. Delay numbers come from the analytic
cost model (mpc/costs.py) scheduled by core/iosched.py — the formulas
of the executable share-level path, evaluated at the paper's geometry.

--mode mpc runs Stage 2 through the wave executor (core/executor.py)
with an MPCEngine interpreting the unified proxy forward; --ring 32
switches the same code path onto the RING32 ring and
--protocol {2pc,3pc,spdz2pc,aby3trunc} picks the secret-sharing backend
(2pc: additive + trusted-dealer Beaver triples, offline bytes reported
separately; 3pc: replicated 2-of-3, dealer-free — zero offline bytes;
spdz2pc: the malicious tier, MAC'd shares that abort on tamper;
aby3trunc: 3pc with ABY3's exact 2-round truncation). --wave/--no-coalesce/
--no-overlap select among Fig 7's four schedule variants at runtime;
openings are round-compressed into fused flights by default
(mpc/fusion.py) — --eager disables the batcher. The output includes
each phase's realized flight ledger plus its exact agreement with the
makespan model. Re-runs resume from phase checkpoints (--no-resume
disables), kept in a directory of the port's own.

--wire local|socket replays each executed phase's captured flights as
real parties (net/: threads over in-process queues, or one spawned
process a party over localhost TCP paced and delayed as `--net`'s
profile), reconciling bytes and payload digests against the phase ledger
and measuring wire_makespan_s; --chaos-seed injects a deterministic
FaultPlan (drops, a latency spike, a reset, one crash) that the reliable
transport and the supervisor recover, --chaos-plan writes each phase's
plan as JSON and --degraded finishes a 3-party phase 2-of-3 after a
crash at its boundary.

The JAX launcher's `--combine` (the Pallas combine's compile mode, a TPU
choice) is dropped: the RING32 combine is the secure_matmul CUDA kernel
on the card and its plain version on the CPU. `--mesh` stays in the
parser and raises NotImplementedError (ROADMAP Queue 1, item 14).
"""
from __future__ import annotations

import argparse
import dataclasses
import getpass
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import iosched, target as tgt
from repro_torch.core.executor import ExecConfig, resolve_device
from repro_torch.core.proxy import ProxySpec
from repro_torch.core.selection import SelectionConfig, run_selection
from repro_torch.data.tasks import make_classification_task
from repro_torch.engine import ClearEngine, MPCEngine
from repro_torch.mpc import costs, prng, protocols
from repro_torch.mpc.comm import WAN, POD_DCN
from repro_torch.mpc.ring import RING32, RING64


def checkpoint_dir() -> str:
    """Phase checkpoints of this launcher: never the JAX launcher's
    `selectformer_phases_<user>`, whose files would otherwise match the
    same fingerprint and be resumed from."""
    return os.path.join(tempfile.gettempdir(),
                        f"selectformer_torch_phases_{getpass.getuser()}")


def _refuse_unported(protocol: str, mesh: str) -> None:
    """Raise for the flag the port cannot serve yet; every `protocol`
    of the registry is served (an unknown one raises ValueError)."""
    protocols.get(protocol)
    if mesh != "none":
        raise NotImplementedError("--mesh is not ported yet (ROADMAP Queue "
                                  "1, item 14)")


def paper_scale_delay(n_pool: int, budget_frac: float, *, seq: int = 128,
                      layers: int = 12, d_model: int = 768, heads: int = 12,
                      classes: int = 2, batch: int = 8) -> dict:
    """Selection delay at paper geometry (BERT-ish) under both nets."""
    g = costs.BlockGeom(batch=batch, seq=seq, d_model=d_model, heads=heads,
                        d_head=d_model // heads, d_ff=4 * d_model)
    budget = int(budget_frac * n_pool)
    phase1 = costs.selection_phase_cost(
        n_pool, int(0.3 * n_pool),
        costs.BlockGeom(batch, seq, d_model, 1, d_model // heads, 0),
        layers=1, classes=classes, mlp_hidden=2)
    phase2 = costs.selection_phase_cost(
        int(0.3 * n_pool), budget, g, layers=3, classes=classes,
        mlp_hidden=16)
    oracle = costs.oracle_selection_cost(n_pool, budget, g, layers=layers,
                                         classes=classes)
    out = {}
    for net_name, net in (("wan", WAN), ("pod_dcn", POD_DCN)):
        sched = iosched.SchedConfig()
        ours = (iosched.makespan(phase1.scaled(batch / n_pool),
                                 -(-n_pool // batch), net, sched)
                + iosched.makespan(phase2.scaled(
                    batch / max(int(0.3 * n_pool), 1)),
                    -(-int(0.3 * n_pool) // batch), net, sched))
        serial = iosched.SchedConfig(coalesce=False, overlap=False)
        orc = iosched.makespan(oracle.scaled(batch / n_pool),
                               -(-n_pool // batch), net, serial)
        out[net_name] = {"ours_hours": ours / 3600,
                         "oracle_hours": orc / 3600,
                         "speedup": orc / max(ours, 1e-9)}
    return out


def run(seed: int = 0, n_pool: int = 800, budget: float = 0.2,
        mode: str = "clear", finetune_steps: int = 250, *,
        wave: int = 8, coalesce: bool = True, overlap: bool = True,
        fuse: bool = True, score_batch: int = 64, ring_bits: int = 64,
        protocol: str = "2pc", resume: bool = True,
        wire: str = "none", net: str = "wan",
        chaos_seed: int | None = None, degraded: bool = False,
        mesh: str = "none", device: str = "cuda") -> dict:
    """The whole pipeline on `device` (the card unless the caller asks
    for the CPU)."""
    _refuse_unported(protocol, mesh)
    dev = resolve_device(device)
    task = make_classification_task(seed, n_pool=n_pool, n_test=400,
                                    seq=16, vocab=256, n_classes=4)
    cfg = dataclasses.replace(TINY_TARGET, vocab_size=task.vocab)
    key = prng.key(seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params0 = tgt.init_classifier(gen, cfg, task.n_classes, device=dev)

    ring = RING32 if ring_bits == 32 else RING64
    engine = MPCEngine(ring=ring, protocol=protocol) if mode == "mpc" \
        else ClearEngine()
    sel = SelectionConfig(
        phases=[ProxySpec(1, 2, 2, 0.4), ProxySpec(2, 4, 8, 1.0)],
        budget_frac=budget, boot_frac=0.05, engine=engine,
        exvivo_steps=150, invivo_steps=80, finetune_steps=100,
        score_batch=score_batch,
        checkpoint_dir=checkpoint_dir(), resume=resume,
        executor=ExecConfig(wave=wave, coalesce=coalesce, overlap=overlap,
                            fuse=fuse, protocol=protocol, wire=wire,
                            net=net, chaos_seed=chaos_seed,
                            degraded=degraded, device=str(dev)))
    t0 = time.time()
    res = run_selection(key, params0, cfg, task.pool_tokens, sel,
                        n_classes=task.n_classes,
                        boot_labels_fn=lambda i: task.pool_labels[i])
    sel_time = time.time() - t0

    # realized §4.4 schedule: per-phase flight ledgers, checked against
    # the analytic makespan's inputs (exact integer agreement)
    executed = None
    if mode == "mpc":
        # ledger_agrees: None until at least one phase actually executed
        # this run — a fully-resumed run must not assert a contract it
        # never checked
        executed = {"phases": [],
                    "ledger_agrees": True if res.exec_reports else None,
                    "resumed_phases": res.resumed_phases}
        for rep in res.exec_reports:
            executed["ledger_agrees"] &= rep.agrees()
            executed["phases"].append(rep.as_dict())

    def finetune_and_eval(idx):
        p, _ = tgt.finetune(prng.fold_in(key, 7), params0, cfg,
                            task.pool_tokens[idx], task.pool_labels[idx],
                            steps=finetune_steps)
        return tgt.accuracy(p, cfg, task.test_tokens, task.test_labels)

    rng = np.random.default_rng(seed)
    rand_idx = rng.choice(n_pool, size=len(res.selected), replace=False)
    acc_ours = finetune_and_eval(res.selected)
    acc_rand = finetune_and_eval(rand_idx)

    delays = paper_scale_delay(42_000, budget)
    return {"acc_ours": acc_ours, "acc_random": acc_rand,
            "gain": acc_ours - acc_rand,
            "appraisal_entropy": res.appraisal_entropy,
            "selection_wall_s": sel_time,
            "paper_scale_delay": delays,
            "executed": executed,
            "n_selected": int(len(res.selected))}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=800)
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--mode", choices=["clear", "mpc"], default="clear")
    ap.add_argument("--wave", type=int, default=8,
                    help="batches coalesced per MPC flight (mode=mpc)")
    ap.add_argument("--score-batch", type=int, default=64)
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable latency-flight coalescing (fig7 'serial')")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable comm/compute double buffering")
    ap.add_argument("--eager", action="store_true",
                    help="disable the flight batcher (fused round "
                         "compression is the default; mpc/fusion.py)")
    ap.add_argument("--ring", type=int, choices=[64, 32], default=64,
                    help="MPC ring: 64 (CrypTen oracle) or 32")
    ap.add_argument("--protocol",
                    choices=["2pc", "3pc", "spdz2pc", "aby3trunc"],
                    default="2pc",
                    help="secret-sharing backend: 2pc (additive + "
                         "trusted-dealer Beaver), 3pc (replicated "
                         "2-of-3, dealer-free), spdz2pc (malicious: "
                         "MAC'd shares, aborts on tamper) or aby3trunc "
                         "(3pc with exact ABY3 truncation)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing phase checkpoints")
    ap.add_argument("--wire", choices=["none", "local", "socket"],
                    default="none",
                    help="execute MPC flights over a real transport "
                         "(net/): 'local' = party threads over in-process "
                         "queues, 'socket' = party processes over paced "
                         "localhost TCP; each phase report gains a "
                         "measured wire_makespan_s (mode=mpc)")
    ap.add_argument("--net", choices=["wan", "pod_dcn", "ici"],
                    default="wan",
                    help="NetProfile the socket transport emulates "
                         "(pacing + injected latency)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a deterministic FaultPlan derived from "
                         "each phase's tape with this seed (drops, "
                         "latency spikes, resets, one crash); requires "
                         "--wire local|socket. Scores stay bitwise "
                         "identical and goodput still reconciles.")
    ap.add_argument("--chaos-plan", type=str, default=None,
                    help="write each wired phase's injected FaultPlan "
                         "as JSON to this path (phase index appended) "
                         "for exact replay")
    ap.add_argument("--degraded", action="store_true",
                    help="with --chaos-seed on an honest-majority "
                         "protocol (3pc/aby3trunc): place the crash at "
                         "a phase boundary and complete 2-of-3 with "
                         "the survivors instead of respawning")
    ap.add_argument("--mesh", choices=["none", "host", "shardmap"],
                    default="none",
                    help="device mesh for the wave executor (not ported "
                         "yet: anything but 'none' raises)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    _refuse_unported(args.protocol, args.mesh)
    out = run(args.seed, args.pool, args.budget, args.mode,
              wave=args.wave, coalesce=not args.no_coalesce,
              overlap=not args.no_overlap, fuse=not args.eager,
              score_batch=args.score_batch,
              ring_bits=args.ring, protocol=args.protocol,
              resume=not args.no_resume, wire=args.wire, net=args.net,
              chaos_seed=args.chaos_seed, degraded=args.degraded,
              device=args.device)
    if out["executed"] is not None:
        ex = out["executed"]
        ph = ex["phases"]
        if ex["resumed_phases"]:
            print(f"[select] resumed {ex['resumed_phases']} phase(s) from "
                  "checkpoints — MPC execution skipped for those "
                  "(re-run with --no-resume to execute everything)")
        if ph:
            print(f"[select] executed {len(ph)} MPC phases, ledger_agrees="
                  f"{ex['ledger_agrees']}; per-phase makespan(WAN) "
                  + ", ".join(f"{p['makespan_wan_s']:.1f}s" for p in ph)
                  + "; measured device makespan "
                  + ", ".join(f"{p['device_makespan_s']:.3f}s"
                              for p in ph))
        wired = [p["wire"] for p in ph if p.get("wire")]
        if wired:
            print("[select] real wire (" + wired[0]["mode"] + "): measured "
                  + ", ".join(f"{w['wire_makespan_s']:.3f}s" for w in wired)
                  + f"; bytes reconciled={all(w['bytes_match'] for w in wired)}")
        chaotic = [w for w in wired if w.get("faults_injected")]
        if chaotic:
            print("[select] chaos: "
                  f"{sum(w['faults_injected'] for w in chaotic)} faults, "
                  f"{sum(w['retries'] for w in chaotic)} retries, "
                  f"{sum(w['respawns'] for w in chaotic)} respawns, "
                  f"{sum(w['retrans_bytes'] for w in chaotic)} retrans B, "
                  "recovery "
                  f"{sum(w['recovery_time_s'] for w in chaotic):.3f}s")
            if args.chaos_plan:
                for i, w in enumerate(chaotic):
                    if w.get("fault_plan"):
                        path = f"{args.chaos_plan}.phase{i}.json"
                        with open(path, "w") as f:
                            f.write(w["fault_plan"])
                        print(f"[select] chaos plan -> {path}")
    d = out["paper_scale_delay"]["wan"]
    print(f"[select] ours={out['acc_ours']:.3f} "
          f"random={out['acc_random']:.3f} (+{out['gain']:.3f}); modeled "
          f"WAN delay {d['ours_hours']:.1f}h vs oracle "
          f"{d['oracle_hours']:.0f}h ({d['speedup']:.0f}x)")


if __name__ == "__main__":
    main()
