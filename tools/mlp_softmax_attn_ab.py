#!/usr/bin/env python3
"""Time the mlp_softmax_attn kernel of one checkout of this repository at
the clear sieve's two cases and their bf16 twin, on one NVIDIA GPU:

    python3 tools/mlp_softmax_attn_ab.py --tree DIR [--reps 100]
        [--clear-sieve N]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/mlp_softmax_attn.py is imported and its kernel
built from its own sources. The cases (chip_smoke.py phase 2): phase 2's
q/k/v (48, 512, 64), hid 16, float32 (the <3,12,16> proxy at batch 4);
phase 1's (4, 512, 64), hid 2 (<1,1,2>); the first in bfloat16. Inputs
come from --seed at phase 2's scales. Each result is checked against the
plain version `ref.mlp_softmax_attn` within 1e-4 (float32) or 1e-2
(bfloat16) of max(1, max |plain|). To compare two trees, run it in one
call on one card, in turns (A, B, B, A). It prints the card's name and
power limit and one JSON line of mean CUDA-event times in ms: `ms` with
the host issuing each call as the program would, `device_ms` with every
launch queued first behind a device-side sleep, so that the events read
the device alone; and `kernels_us`, the wrapper's device time split by
kernel (torch.profiler over --reps calls, mean microseconds a call).
With --clear-sieve N it also runs the path the kernel serves, DIR's
chip_smoke.py phase 6b: the two-phase clear sieve (64 -> 24 -> 8,
batch 4) on its BERT-width proxies, once to warm up, N times timed by
the host clock (ending in a synchronize) and once under torch.profiler
(the device's kernel ms and the kernel's share).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# label -> (BH, S, Dh, hid, dtype name)
CASES = {"path phase 2": (48, 512, 64, 16, "float32"),
         "path phase 1": (4, 512, 64, 2, "float32"),
         "bf16": (48, 512, 64, 16, "bfloat16")}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clear-sieve", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mlp_softmax_attn_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import mlp_softmax_attn as msa_k
    from repro_torch.kernels import ref

    def ms(fn, queued=False):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queued:
            torch.cuda._sleep(1_000_000_000)
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    def by_kernel(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                times[e.key[:80]] = us / args.reps
        return times

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    out = {"tree": os.path.abspath(args.tree), "file": msa_k.__file__}
    ok = True
    for label, (bh, s, dh, hid, dname) in CASES.items():
        dt = getattr(torch, dname)
        q, k, v = (randn((bh, s, dh), dtype=dt) for _ in range(3))
        w = (randn((s, hid), 0.2), randn((hid,), 0.1), randn((hid, s), 0.2),
             randn((s,), 0.01))
        got = msa_k.launch(q, k, v, *w)
        want = ref.mlp_softmax_attn(q, k, v, *w)
        err = float((got.double() - want.double()).abs().max())
        rel = err / max(1.0, float(want.double().abs().max()))
        good = rel <= TOL[dname]
        ok = ok and good
        out[label] = {"shape": f"({bh},{s},{dh}) hid {hid} {dname}",
                      "ms": ms(lambda: msa_k.launch(q, k, v, *w)),
                      "device_ms": ms(lambda: msa_k.launch(q, k, v, *w),
                                      queued=True),
                      "kernels_us": by_kernel(
                          lambda: msa_k.launch(q, k, v, *w)),
                      "rel_err": rel, "within_tolerance": good}
    if args.clear_sieve:
        out["clear_sieve"] = clear_sieve(args, torch)
        ok = ok and out["clear_sieve"]["plain_calls"] == 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if ok else 1


def clear_sieve(args, torch) -> dict:
    """Walls (s) of the tree's clear sieve, its kernel ms and the
    kernel's launches and plain calls in the profiled run."""
    import dataclasses
    import time

    import numpy as np
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from repro_torch.core.selection import _phase_keep, clear_phase
    from repro_torch.engine import FULL_VARIANT, ClearEngine
    from repro_torch.kernels import ops as kops
    from torch.profiler import ProfilerActivity, profile
    cfg, specs, pps = cs.build_proxies(args.seed)
    specs = [dataclasses.replace(specs[0],
                                 selectivity=cs.KEEPS[0] / cs.POOL),
             *specs[1:]]
    keeps = _phase_keep(cs.POOL, cs.KEEPS[-1], specs)
    pool = np.random.default_rng(args.seed).integers(0, cfg.vocab_size,
                                                     (cs.POOL, cs.SEQ))

    def run():
        surviving = np.arange(cs.POOL)
        for spec, pp, keep in zip(specs, pps, keeps):
            surviving = clear_phase(ClearEngine(), pp, cfg, pool, surviving,
                                    spec, keep, FULL_VARIANT,
                                    batch=cs.BATCH)[0]
        torch.cuda.synchronize()
        return surviving

    run()
    walls = []
    for _ in range(args.clear_sieve):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    kops.reset_msa_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kernel_ms = msa_ms = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernel_ms += us / 1e3
        if "mlp_softmax_attn_kernel" in e.key:
            msa_ms += us / 1e3
    st = kops.msa_stats()
    return {"walls_s": walls, "kernel_ms": kernel_ms,
            "mlp_softmax_attn_ms": msa_ms, "launches": st["kernel"],
            "plain_calls": st["ref"]}


if __name__ == "__main__":
    sys.exit(main())
