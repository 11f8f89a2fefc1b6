#!/usr/bin/env python3
"""Time the rg_lru kernel of one checkout of this repository at the
serving path's case, on one NVIDIA GPU:

    python3 tools/rg_lru_ab.py --tree DIR [--reps 100] [--copies 4]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/rg_lru.py is imported and its kernel built from
its own sources. The case is one RecurrentGemma 2B prefill batch's
recurrence, a and b (4, 512, 2560) float32 (chip_smoke.py phase 2), a =
sigmoid(N(0, 1)) and b = N(0, 1) from --seed. The result is checked
against the plain version `ref.rg_lru` within 1e-5 of max(1, max
|plain|), and a second launch must equal the first bitwise. To compare
two trees, run it in one call on one card, in turns (A, B, B, A). It
prints the card's name and power limit and one JSON line of mean
CUDA-event times in ms: `ms` with the host issuing each call as the
program would, `device_ms` with every launch queued first behind a
device-side sleep, so that the events read the device alone, and
`rotating_device_ms` the same over --copies copies of the inputs taken
in turn (42 MB each, so that four outrun the 50 MB L2 cache and the
inputs come from device memory, as they would on the path); beside them
the bytes bound (a and b read, h written once, at 3.35 TB/s), each
time's share of it, and the kernel's registers and spills from its
build.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPE = (4, 512, 2560)                 # B, T, D
TOL = 1e-5
PEAK_BYTES_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rg_lru_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as lru_k

    def ms(inputs, queued=False):
        for x in inputs[:3]:
            lru_k.launch(*x)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queued:
            torch.cuda._sleep(1_000_000_000)
        t0.record()
        for i in range(args.reps):
            lru_k.launch(*inputs[i % len(inputs)])
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    copies = [(torch.sigmoid(torch.randn(SHAPE, generator=gen,
                                         device="cuda")),
               torch.randn(SHAPE, generator=gen, device="cuda"))
              for _ in range(max(1, args.copies))]
    a, b = copies[0]
    got = lru_k.launch(a, b)
    again = lru_k.launch(a, b)
    want = ref.rg_lru(a, b)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    rel = err / max(1.0, float(want.double().abs().max()))
    bitwise = bool(torch.equal(got, again))
    del got, again, want
    bound = 3 * a.numel() * 4 / PEAK_BYTES_S * 1e3
    out = {"tree": os.path.abspath(args.tree), "file": lru_k.__file__,
           "shape": f"{SHAPE} f32", "ms": ms([(a, b)]),
           "device_ms": ms([(a, b)], queued=True),
           "rotating_device_ms": ms(copies, queued=True),
           "copies": len(copies), "bound_ms": bound, "bound_by": "bytes",
           "rel_err": rel, "within_tolerance": rel <= TOL,
           "bitwise_repeat": bitwise,
           "build": build.ptxas_entries(build.ptxas_log("rg_lru"))}
    for key in ("ms", "device_ms", "rotating_device_ms"):
        out[key.replace("ms", "bound_share")] = bound / out[key]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if out["within_tolerance"] and bitwise else 1


if __name__ == "__main__":
    sys.exit(main())
