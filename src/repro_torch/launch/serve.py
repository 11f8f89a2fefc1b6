"""Token server: batched prefill + decode — the port of
repro/launch/serve.py's token decoding.

    python -m repro_torch.launch.serve --arch mamba2_2_7b --full

Requests arrive with prompts, are batched to the configured slot count,
left-padded, prefilled once, then decoded step-locked with greedy
(argmax) tokens; finished sequences free their slots for the next queued
requests (continuous batching at slot granularity). The ssm (mamba2_2_7b)
and hybrid (recurrentgemma_2b) families are ported; their prefill runs
on the `ssd`, `rg_lru` and `flash_attn` kernels on the card. The JAX
package's device mesh and sharding rules are the identity on one card
and are dropped. `--appraise` (the appraisal service) is not ported yet
(ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, load_arch
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeConfig:
    arch: str = "mamba2_2_7b"
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2_2_7b", choices=ARCH_IDS)
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
                    help="serve appraisals instead of tokens (not ported yet)")
    args = ap.parse_args(argv)
    if args.appraise:
        raise NotImplementedError("--appraise (the appraisal service) is "
                                  "not ported yet (ROADMAP Queue 1, item "
                                  "10)")
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
