#!/usr/bin/env python3
"""Time the ring_matmul kernel of one checkout of this repository at the
four main-path cases, on both rings, on one NVIDIA GPU:

    python3 tools/ring_matmul_ab.py --tree DIR [--reps 50]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/ring_matmul.py is imported and its kernel built
from its own sources. The cases are the private sieve's phase-2 products
at BERT width in a wave of 4 lanes (chip_smoke.py phase 2): the
attention scores (384, 512, 64) @ (384, 64, 512), probs @ v (192, 512,
512) @ (192, 512, 64), a projection (4, 2048, 768) @ (4, 768, 768) and
the MLP's first layer (4, 24576, 512) @ (4, 512, 16), each in int32 and
int64, inputs from --seed. Each result is checked bitwise against the
plain version. To compare two trees, run it in one call on one card, in
turns (A, B, B, A). It prints the card's name and power limit and one
JSON line of mean CUDA-event times in ms: `ms` with the host issuing
each call as the program would, `device_ms` with every launch queued
first behind a device-side sleep, so that the events read the device
alone.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = (  # (name, batch, M, K, N)
    ("scores eb", 384, 512, 64, 512),
    ("probs@v", 192, 512, 512, 64),
    ("proj", 4, 2048, 768, 768),
    ("mlp_sm w1", 4, 24576, 512, 16))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ring_matmul_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_matmul as rmm

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

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"tree": os.path.abspath(args.tree), "file": rmm.__file__}
    for dt in (torch.int32, torch.int64):
        info = torch.iinfo(dt)
        for name, batch, m, k, n in CASES:
            a, b = (torch.randint(info.min, info.max, shape, generator=gen,
                                  dtype=dt, device="cuda")
                    for shape in ((batch, m, k), (batch, k, n)))
            equal = torch.equal(rmm.launch(a, b), ref.matmul_by_chunks(a, b))
            out[f"{name} {str(dt)[6:]}"] = {
                "ms": ms(lambda: rmm.launch(a, b)),
                "device_ms": ms(lambda: rmm.launch(a, b), queued=True),
                "bitwise_equal": equal}
            del a, b
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if all(v["bitwise_equal"] for v in out.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
