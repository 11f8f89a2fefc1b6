#!/usr/bin/env python3
"""Time the ssd kernel of one checkout of this repository at the serving
path's case and its float32 counterpart, and its backward kernel at the
training path's, on one NVIDIA GPU:

    python3 tools/ssd_ab.py --tree DIR [--reps 50] [--bwd-only]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/ssd.py is imported and its kernel built from its
own sources. The cases are one Mamba-2 2.7B prefill batch, x (4, 512,
80, 64) with b/c (4, 512, 128) and chunk 128 (chip_smoke.py phase 2), in
bfloat16 (the path's dtype) and in float32, inputs from --seed. Each
result is checked against the plain chunked scan `ref.ssd_chunked`: y
within 1e-2 (bfloat16) or 1e-5 (float32) of max(1, max |plain|), the
final state within 1e-5. To compare two trees, run it in one call on one
card, in turns (A, B, B, A). It prints the card's name and power limit
and one JSON line of mean CUDA-event times in ms: `ms` with the host
issuing each call as the program would, `device_ms` with every launch
queued first behind a device-side sleep, so that the events read the
device alone.

The backward (`bwd_bfloat16`, `bwd_float32`) is one Mamba-2 2.7B
layer's at the training batch, x and dy (2, 512, 80, 64) with b/c (2,
512, 128), in bfloat16 (the path's) and in float32 (a user who trains at
float32), inputs from --seed and the model's log decays (-0.1 to -2.1),
without initial or final state (chip_smoke.py phase 2's path cases): its
gradients against the plain backward `ref.ssd_bwd` within 1e-2 (bf16)
or 1e-4 (float32) of max(1, max |plain|), a second launch bitwise equal,
`ms` and `device_ms` as above, the plain version's host-issued
`plain_ms`, the bound of `ssd.bwd_work` (bytes at 3.35 TB/s, operations
at 989 TFLOP/s in bf16 and 3xTF32's 165 in float32) and its share in
device time, each kernel's device time from a profiler trace
(`launches_ms`, by kernel name) and the kernels' registers and spills
from the build. --bwd-only skips the forward.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SHAPE = (4, 512, 80, 64, 128)          # B, T, H, P, N
BWD_SHAPE = (2, 512, 80, 64, 128)
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 495e12 / 3}
CHUNK = 128
TOL = {"bfloat16": (1e-2, 1e-5), "float32": (1e-5, 1e-5)}   # y, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bwd-only", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_k

    def ms(fn, queued=False, reps=None):
        reps = args.reps if reps is None else reps
        for _ in range(min(3, reps)):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queued:
            torch.cuda._sleep(1_000_000_000)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def rel(got, want):
        err = float((got.double() - want.double()).abs().max())
        return err / max(1.0, float(want.double().abs().max()))

    def launches_ms(fn):
        """Device ms a call of each backward kernel, by name, from a
        torch.profiler trace of --reps calls."""
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(r"ssd_bwd_\w*?_kernel", e.key)
            if m:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                out[m.group(0)] = (out.get(m.group(0), 0.0)
                                   + us / 1e3 / args.reps)
        return out

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bsz, t, h, p, n = SHAPE
    out = {"tree": os.path.abspath(args.tree), "file": ssd_k.__file__}
    ok = True
    for dt in () if args.bwd_only else (torch.bfloat16, torch.float32):
        def randn(shape, scale=1.0, dtype=dt):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(dtype)
        x = randn((bsz, t, h, p))
        a = -randn((bsz, t, h), 0.5, torch.float32).abs()
        b, c = randn((bsz, t, n), 0.3), randn((bsz, t, n), 0.3)
        y, s = ssd_k.launch(x, a, b, c, CHUNK)
        want_y, want_s = ref.ssd_chunked(x, a, b, c, CHUNK)
        name = str(dt)[6:]
        errs = (rel(y, want_y), rel(s, want_s))
        good = all(e <= tol for e, tol in zip(errs, TOL[name]))
        ok = ok and good
        out[name] = {"ms": ms(lambda: ssd_k.launch(x, a, b, c, CHUNK)),
                     "device_ms": ms(lambda: ssd_k.launch(x, a, b, c, CHUNK),
                                     queued=True),
                     "y_rel_err": errs[0], "state_rel_err": errs[1],
                     "within_tolerance": good}
        del x, a, b, c, y, s, want_y, want_s
    bsz, t, h, p, n = BWD_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        x, dy = (torch.randn((bsz, t, h, p), generator=gen, device="cuda")
                 .to(dt) for _ in range(2))
        b, c = (torch.randn((bsz, t, n), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        a = -0.1 - 2.0 * torch.rand((bsz, t, h), generator=gen,
                                    device="cuda")
        args_ = (x, a, b, c, dy)
        got = ssd_k.launch_bwd(*args_)
        again = ssd_k.launch_bwd(*args_)
        want = ref.ssd_bwd(*args_)
        torch.cuda.synchronize()
        err = max(rel(g, w) for g, w in zip(got[:4], want[:4]))
        bitwise = all(torch.equal(u, v) for u, v in zip(got[:4], again[:4]))
        del got, again, want
        ops, nbytes = ssd_k.bwd_work(bsz, t, h, p, n, dt)
        bound = max(ops / PEAK_OPS_S[name], nbytes / PEAK_BYTES_S) * 1e3
        r = {"shape": f"{BWD_SHAPE} {name}",
             "ms": ms(lambda: ssd_k.launch_bwd(*args_)),
             "device_ms": ms(lambda: ssd_k.launch_bwd(*args_), queued=True),
             # the plain version steps through T on the host: 2 calls
             "plain_ms": ms(lambda: ref.ssd_bwd(*args_), reps=2),
             "bound_ms": bound,
             "bound_by": "bytes" if nbytes / PEAK_BYTES_S
             >= ops / PEAK_OPS_S[name] else "operations",
             "rel_err": err, "within_tolerance": err <= BWD_TOL[name],
             "bitwise_repeat": bitwise,
             "launches_ms": launches_ms(lambda: ssd_k.launch_bwd(*args_))}
        r["bound_share"] = bound / r["device_ms"]
        out[f"bwd_{name}"] = r
        ok = ok and r["within_tolerance"] and bitwise
        del x, dy, b, c, a, args_
    out["build"] = {fn: e for fn, e in build.ptxas_entries(
        build.ptxas_log("ssd_bwd")).items() if "ssd_bwd" in fn}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
