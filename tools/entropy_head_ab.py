#!/usr/bin/env python3
"""Time the entropy_head kernel of one checkout of this repository at the
Oracle's case and at vocabulary width, on one NVIDIA GPU:

    python3 tools/entropy_head_ab.py --tree DIR [--reps 100] [--copies 4]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/entropy_head.py is imported and its kernel built
from its own sources. The cases are the Oracle's batch (16, 2) float32
(chip_smoke.py phase 6a), the vocabulary-wide head (256, 30,522) in
float32 and bfloat16 (phase 2), and two serving heads with few rows,
(16, 30,522) and (4, 256,000) float32; logits N(0, 9) from --seed. Each
result is checked against the plain version `ref.entropy_head` within
1e-5 of max(1, max |plain|), and a second launch must equal the first
bitwise. To compare two trees, run it in one call on one card, in turns
(A, B, B, A). It prints the card's name and power limit and one JSON
line a case of mean CUDA-event times in ms: `ms` with the host issuing
each call as the program would, `device_ms` with every launch queued
first behind a device-side sleep, so that the events read the device
alone, and `rotating_device_ms` the same over --copies copies of the
logits taken in turn (four copies of the vocab case, 31 MB each, outrun
the 50 MB L2 cache, so that the logits come from device memory); beside
them the bytes bound (the logits read once, H written once, at
3.35 TB/s) and each time's share of it, the plain version's time, the
yardstick `torch.distributions.Categorical(logits=x).entropy()` (one
PyTorch call computing the same function, host-issued and device), and
the kernel's registers and spills from its build, and the device time
of `torch.amax(x, -1)`, a library reduction reading the same bytes once
(what one read of the logits costs a library kernel), repeated and over
the copies.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# label, (R, V), dtype name
CASES = (("path (Oracle batch)", (16, 2), "float32"),
         ("vocab", (256, 30522), "float32"),
         ("vocab bf16", (256, 30522), "bfloat16"),
         ("few rows", (16, 30522), "float32"),
         ("serving head", (4, 256000), "float32"))
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
        print("entropy_head_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import entropy_head as eh
    from repro_torch.kernels import ref

    def ms(fn, inputs, reps, queued=False):
        for x in inputs[:3]:
            fn(x)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queued:
            torch.cuda._sleep(1_000_000_000)
        t0.record()
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def categorical(x):
        return torch.distributions.Categorical(
            logits=x, validate_args=False).entropy()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = True
    for label, (r, v), dt_name in CASES:
        dt = getattr(torch, dt_name)
        copies = [(torch.randn((r, v), generator=gen, device="cuda")
                   * 3.0).to(dt) for _ in range(max(1, args.copies))]
        x = copies[0]
        got = eh.launch(x)
        again = eh.launch(x)
        want = ref.entropy_head(x)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        rel = err / max(1.0, float(want.double().abs().max()))
        bitwise = bool(torch.equal(got, again))
        ok = ok and rel <= TOL and bitwise
        del got, again, want
        nbytes = r * v * x.element_size() + 4 * r
        bound = nbytes / PEAK_BYTES_S * 1e3
        out = {"tree": os.path.abspath(args.tree), "case": label,
               "shape": f"({r},{v}) {dt_name}",
               "ms": ms(eh.launch, [x], args.reps),
               "device_ms": ms(eh.launch, [x], args.reps, queued=True),
               "rotating_device_ms": ms(eh.launch, copies, args.reps,
                                        queued=True),
               "copies": len(copies), "bound_ms": bound, "bound_by": "bytes",
               "plain_ms": ms(ref.entropy_head, [x], 20),
               "plain_device_ms": ms(ref.entropy_head, [x], 20, queued=True),
               "library_ms": ms(categorical, [x], 20),
               "library_device_ms": ms(categorical, [x], 20, queued=True),
               "amax_device_ms": ms(lambda y: torch.amax(y, -1), [x], 20,
                                    queued=True),
               "amax_rotating_device_ms": ms(lambda y: torch.amax(y, -1),
                                             copies, 20, queued=True),
               "rel_err": rel, "within_tolerance": rel <= TOL,
               "bitwise_repeat": bitwise}
        for key in ("ms", "device_ms", "rotating_device_ms"):
            out[key.replace("ms", "bound_share")] = bound / out[key]
        if hasattr(eh, "plan"):
            out["plan"] = eh.plan(r, v)
        print(json.dumps(out))
        del copies, x
    print(json.dumps({"tree": os.path.abspath(args.tree), "build":
                      build.ptxas_entries(build.ptxas_log("entropy_head"))}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
