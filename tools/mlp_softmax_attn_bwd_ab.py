#!/usr/bin/env python3
"""Time the mlp_softmax_attn backward of one checkout of this repository
at the in-vivo finetune's cases, on one NVIDIA GPU:

    python3 tools/mlp_softmax_attn_bwd_ab.py --tree DIR [--reps 50]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/mlp_softmax_attn.py is imported and its kernels
built from its own sources. The cases are one MLP_sm attention layer's
backward in the in-vivo finetune at batch 8 (chip_smoke.py phases 2 and
8a), float32: phase 2's proxy <3,12,16> gives q, k, v, do (96, 512, 64)
and hid 16 (the path case), phase 1's <1,1,2> (8, 512, 64) and hid 2.
Inputs come from --seed at chip_smoke.py phase 2's scales (q, k, v, do
N(0, 1); w1, w2 N(0, 0.2); b1 N(0, 0.1); b2 N(0, 0.01)). Each gradient is
checked against the plain version `ref.mlp_softmax_attn_bwd` within 1e-4
of max(1, max |plain|), and a second call must equal the first bitwise;
the wrapper's and the plain version's gradients are also held against
the plain version in float64 (`rms_err_vs_float64`: each gradient's RMS
error over its RMS, in the order dq, dk, dv, dw1, db1, dw2, db2). To
compare two trees, run it in one call on one card, in turns (A, B, B,
A). It prints the card's name and power limit and one JSON line of mean
CUDA-event times in ms: `ms` with the host issuing each call as the
program would, `device_ms` with every launch queued first behind a
device-side sleep, so that the events read the device alone; the plain
version's `plain_ms`; the bound of `mlp_softmax_attn.bwd_work` (bytes at
3.35 TB/s against operations at 3xTF32's 165 TFLOP/s) and the share of
it in device time; a profiler split of one call by device kernel
(`split`: device ms and launches a call of each kernel the call runs,
hand-written or not, `kernels_per_call` their sum); and the backward
kernels' registers and spills from their build.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (label, BH, S, Dh, hid): in-vivo at batch 8 x 12 heads (phase 2's
# proxy) and 8 x 1 head (phase 1's)
CASES = (("path", 96, 512, 64, 16), ("phase1", 8, 512, 64, 2))
TOL = 1e-4
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 495e12 / 3
NAMES = ("dq", "dk", "dv", "dw1", "db1", "dw2", "db2")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mlp_softmax_attn_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import mlp_softmax_attn as msa
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

    def split(fn):
        """Device ms and launches a call of every device kernel fn runs,
        from a torch.profiler trace of --reps calls."""
        act = torch.profiler.ProfilerActivity
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            out[e.key[:120]] = {"ms": us / 1e3 / args.reps,
                                "launches": e.count / args.reps}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {"tree": os.path.abspath(args.tree), "file": msa.__file__}
    ok = True
    for label, bh, s, dh, hid in CASES:
        q, k, v = (randn((bh, s, dh)) for _ in range(3))
        w = [randn(sh, sc) for sh, sc in (((s, hid), 0.2), ((hid,), 0.1),
                                          ((hid, s), 0.2), ((s,), 0.01))]
        do = randn((bh, s, dh))
        ins = (q, k, v, *w, do)
        got = msa.launch_bwd(*ins)
        again = msa.launch_bwd(*ins)
        want = ref.mlp_softmax_attn_bwd(*ins)
        torch.cuda.synchronize()
        rel = max(float((g.double() - x.double()).abs().max())
                  / max(1.0, float(x.double().abs().max()))
                  for g, x in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        exact = ref.mlp_softmax_attn_bwd(*(x.double() for x in ins))
        f64 = {name: [float((a.double() - e).pow(2).mean().sqrt()
                            / e.pow(2).mean().sqrt())
                      for a, e in zip(g, exact)]
               for name, g in (("kernel", got), ("plain", want))}
        del got, again, want, exact

        def kernel():
            return msa.launch_bwd(*ins)

        def plain():
            return ref.mlp_softmax_attn_bwd(*ins)
        nbytes, ops = msa.bwd_work(bh, 1, s, s, dh, hid, torch.float32)
        bound = max(ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S) * 1e3
        r = {"shape": f"({bh},{s},{dh}) hid {hid} float32",
             "ms": ms(kernel), "device_ms": ms(kernel, queued=True),
             "plain_ms": ms(plain), "bound_ms": bound,
             "bound_by": ("bytes" if nbytes / PEAK_BYTES_S
                          >= ops / PEAK_OPS_S else "operations"),
             "rel_err": rel, "within_tolerance": rel <= TOL,
             "bitwise_repeat": bitwise, "rms_err_vs_float64": f64,
             "rms_order": list(NAMES), "split": split(kernel)}
        r["kernels_per_call"] = sum(x["launches"] for x in
                                    r["split"].values())
        r["bound_share"] = bound / r["device_ms"]
        out[label] = r
        ok = ok and r["within_tolerance"] and bitwise
    out["build"] = build.ptxas_entries(build.ptxas_log(
        "mlp_softmax_attn_bwd"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
