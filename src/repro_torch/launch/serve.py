"""Serving: batched prefill + decode, and the appraisal service — the
port of repro/launch/serve.py.

    python -m repro_torch.launch.serve --arch qwen2_0_5b --full
    python -m repro_torch.launch.serve --appraise [--device cpu]

Two serving modes share this entry point:

  token decoding (default)   requests arrive with prompts, are batched
      to the configured slot count, left-padded, prefilled once, then
      decoded step-locked with greedy (argmax) tokens; finished
      sequences free their slots for the next queued requests
      (continuous batching at slot granularity). The dense, moe, ssm
      and hybrid families are served, as by the JAX server; on the card
      their prefill runs on the `flash_attn`, `ssd` and `rg_lru`
      kernels. The vlm and encdec families take stub `patches` /
      `frames` beside their tokens, which requests do not carry: they
      are driven through `models.transformer.prefill` / `decode_step`
      directly, and the Server refuses them. The JAX package's device
      mesh and sharding rules are the identity on one card and are
      dropped.
  --appraise                 requests are (data-owner, model-owner)
      APPRAISAL sessions: `repro_torch.serve.AppraisalServer` decomposes
      each into its multiphase MPC schedule, continuously batches waves
      across sessions, pipelines the offline dealer (drawn on the
      card), and serves fingerprint-identical phases from the
      cross-session cache. Writes SERVE_report.json whose per-phase
      dicts are PhaseReport.as_dict. `--protocol` picks any of the four
      backends (2pc, 3pc, spdz2pc, aby3trunc); the dealer-free ones
      (3pc, aby3trunc) place no dealer order.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, load_arch
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeConfig:
    arch: str = "qwen2_0_5b"
    smoke: bool = True
    slots: int = 4                 # concurrent sequences
    max_len: int = 128
    max_new: int = 16
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) tokens
    out: list[int] = dataclasses.field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Token server over one model. `params` (a tree of tensors, e.g.
    carried from the JAX package with `core.tree.to_device`) replace the
    random weights drawn from `sc.seed` on `device`."""

    def __init__(self, sc: ServeConfig, device="cuda", params=None):
        self.sc = sc
        self.device = torch.device(device)
        self.cfg = load_arch(sc.arch, smoke=sc.smoke)
        if self.cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"{sc.arch}: the {self.cfg.family} family takes stub "
                f"{'patches' if self.cfg.family == 'vlm' else 'frames'} "
                "beside its tokens, which a Request does not carry; drive "
                "it through models.transformer.prefill / decode_step")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(sc.seed)
            params = T.init_params(gen, self.cfg, self.device)
        self.params = params

    def run(self, requests: list[Request]) -> dict:
        """Serve every request; returns counts, rates, the prefill and
        decode wall time (host clock, each ending in a synchronize) and
        each request's greedy tokens."""
        sc, dev = self.sc, self.device
        queue = list(requests)
        done: list[Request] = []
        t0 = time.time()
        tokens_out = 0
        prefill_s = decode_s = 0.0
        with torch.no_grad():
            while queue:
                active = queue[:sc.slots]
                queue = queue[sc.slots:]
                s = max(len(r.prompt) for r in active)
                toks = np.zeros((len(active), s), np.int64)
                for i, r in enumerate(active):
                    toks[i, -len(r.prompt):] = r.prompt     # left-pad
                t1 = time.time()
                logits, cache = T.prefill(
                    self.params, self.cfg,
                    {"tokens": torch.as_tensor(toks, device=dev)},
                    max_len=sc.max_len)
                step_tok = logits.argmax(-1)[:, None]
                for r, t in zip(active, step_tok[:, 0].tolist()):
                    r.out.append(t)
                _sync(dev)
                t2 = time.time()
                prefill_s += t2 - t1
                for j in range(sc.max_new - 1):
                    logits, cache = T.decode_step(self.params, self.cfg,
                                                  cache, {"tokens": step_tok},
                                                  s + j)
                    step_tok = logits.argmax(-1)[:, None]
                    for r, t in zip(active, step_tok[:, 0].tolist()):
                        r.out.append(t)
                    tokens_out += len(active)
                _sync(dev)
                decode_s += time.time() - t2
                done.extend(active)
        dt = time.time() - t0
        return {"requests": len(done), "tokens": tokens_out,
                "tok_per_s": tokens_out / max(dt, 1e-9), "wall_s": dt,
                "prefill_s": prefill_s, "decode_s": decode_s,
                "outputs": {r.rid: r.out for r in done}}


def appraise(n_sessions: int = 3, n_pool: int = 96, protocol: str = "2pc",
             ring_bits: int = 64, seed: int = 0, repeat_first: bool = True,
             out_path: str | None = "SERVE_report.json",
             device="cuda") -> dict:
    """Run an appraisal-service queue on `device` and emit
    SERVE_report.json.

    Builds `n_sessions` synthetic appraisal sessions (tiny target +
    synthetic task, the Stage-2 smoke geometry); with `repeat_first` the
    second session duplicates the first — the cross-session cache serves
    its phases without re-execution."""
    from repro_torch.configs.paper_targets import TINY_TARGET
    from repro_torch.core import target as tgt
    from repro_torch.core.executor import ExecConfig, resolve_device
    from repro_torch.core.proxy import ProxySpec
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data.tasks import make_classification_task
    from repro_torch.engine import MPCEngine
    from repro_torch.mpc import prng, protocols
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.serve import AppraisalServer, SessionSpec

    protocols.get(protocol)          # raises for an unknown name
    dev = resolve_device(device)
    ring = RING32 if ring_bits == 32 else RING64

    def spec(sid: str, task_seed: int) -> SessionSpec:
        task = make_classification_task(task_seed, n_pool=n_pool, n_test=32,
                                        seq=8, vocab=64, n_classes=2)
        cfg = dataclasses.replace(TINY_TARGET, vocab_size=task.vocab)
        gen = torch.Generator(device=dev).manual_seed(task_seed)
        params0 = tgt.init_classifier(gen, cfg, task.n_classes, device=dev)
        sel = SelectionConfig(
            phases=[ProxySpec(1, 1, 2, 0.5), ProxySpec(1, 2, 4, 1.0)],
            budget_frac=0.25, boot_frac=0.1,
            engine=MPCEngine(ring=ring, protocol=protocol),
            exvivo_steps=4, invivo_steps=2, finetune_steps=2,
            score_batch=16, checkpoint_dir=None,
            executor=ExecConfig(wave=2, ring=ring, protocol=protocol,
                                device=str(dev)))
        return SessionSpec(sid=sid, key=prng.key(task_seed, device=dev),
                           target_params=params0, arch_cfg=cfg,
                           pool_tokens=task.pool_tokens, sel=sel,
                           n_classes=task.n_classes,
                           boot_labels_fn=lambda i: task.pool_labels[i])

    srv = AppraisalServer(dealer_seed=seed, device=dev)
    try:
        for i in range(n_sessions):
            task_seed = seed if (repeat_first and i == 1) else seed + i
            srv.submit(spec(f"s{i}", task_seed))
        report = srv.run()
    finally:
        srv.close()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1, default=float)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic requests to enqueue")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (continuous batching "
                         "granularity)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="prefill/KV-cache length budget per slot")
    ap.add_argument("--max-new", type=int, default=8,
                    help="tokens decoded per request")
    ap.add_argument("--seed", type=int, default=0,
                    help="parameter-init and synthetic-prompt seed")
    ap.add_argument("--full", action="store_true",
                    help="full-size architecture (default is the smoke "
                         "geometry)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--appraise", action="store_true",
                    help="serve APPRAISAL sessions through the "
                         "repro_torch.serve AppraisalServer instead of "
                         "token decoding; writes SERVE_report.json")
    ap.add_argument("--sessions", type=int, default=3,
                    help="appraisal sessions to enqueue (--appraise)")
    ap.add_argument("--pool", type=int, default=96,
                    help="candidate pool size per session (--appraise)")
    ap.add_argument("--protocol",
                    choices=["2pc", "3pc", "spdz2pc", "aby3trunc"],
                    default="2pc", help="MPC backend (--appraise)")
    ap.add_argument("--ring", type=int, choices=[64, 32], default=64,
                    help="MPC ring width (--appraise)")
    ap.add_argument("--out", default="SERVE_report.json",
                    help="report path (--appraise)")
    args = ap.parse_args(argv)
    if args.appraise:
        rep = appraise(n_sessions=args.sessions, n_pool=args.pool,
                       protocol=args.protocol, ring_bits=args.ring,
                       seed=args.seed, out_path=args.out,
                       device=args.device)
        t = rep["throughput"]
        print(f"[serve] {t['n_sessions']} appraisals: "
              f"{t['serve_appraisals_per_hour']:.2f}/h served vs "
              f"{t['sequential_appraisals_per_hour']:.2f}/h sequential "
              f"({t['speedup']:.2f}x); cache {rep['cache']['hits']} hits/"
              f"{rep['cache']['misses']} misses; dealer stall "
              f"{rep['dealer']['dealer_stall_s']:.3f}s; "
              f"ledger_agrees={rep['ledger_agrees']} -> {args.out}")
        return
    sc = ServeConfig(arch=args.arch, smoke=not args.full, slots=args.slots,
                     max_len=args.max_len, max_new=args.max_new,
                     seed=args.seed)
    srv = Server(sc, device=args.device)
    rng = np.random.default_rng(sc.seed)
    reqs = [Request(i, rng.integers(0, srv.cfg.vocab_size,
                                    size=rng.integers(4, 12)))
            for i in range(args.requests)]
    out = srv.run(reqs)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens, "
          f"{out['tok_per_s']:.1f} tok/s (prefill {out['prefill_s']:.3f} s, "
          f"decode {out['decode_s']:.3f} s)")


if __name__ == "__main__":
    main()
