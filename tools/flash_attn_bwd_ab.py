#!/usr/bin/env python3
"""Time the flash_attn backward kernel of one checkout of this repository
at one of its path cases, on one NVIDIA GPU:

    python3 tools/flash_attn_bwd_ab.py --tree DIR [--case CASE] [--reps 50]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/flash_attn.py is imported and its kernels built
from its own sources. The cases (chip_smoke.py phase 2):
- mg (the default): one attention layer's backward in the target's
  finetune at BERT width (phase 8a), q, k, v, do (96, 512, 64),
  bidirectional, in float32 (the path's) and in bfloat16;
- local: RecurrentGemma's local layer at the training batch of 2, q (20,
  512, 256), k, v (2, 512, 256) (group 10), causal, window 2048, bf16;
- prefix: PaliGemma's layer at the training batch of 2, q (16, 768, 256),
  k, v (2, 768, 256) (group 8), the prefix mask of 256, bf16;
- f32: phase 2's float32 Dh-256 case, q (8, 300, 256), k, v (4, 300,
  256) (group 2), causal, float32;
- local_f32, prefix_f32: the float32 twins of local and prefix, the
  shapes a user who sets the model's dtype to float32 trains at.
Inputs are N(0, 1) from --seed and o comes from the forward kernel. Each
gradient is checked against the plain version `ref.flash_attn_bwd`
within 1e-4 (float32) or 1e-2 (bf16) of max(1, max |plain|), and a second
launch must equal the first bitwise; the kernel's and the plain version's
gradients are also held against the plain version in float64 on the same
inputs (`rms_err_vs_float64`: each gradient's RMS error over its RMS, dq,
dk, dv). To compare two trees, run it in one call on one card, in turns
(A, B, B, A). It prints the card's name and power limit and one JSON line
of mean CUDA-event times in ms: `ms` with the host issuing each call as
the program would, `device_ms` with every launch queued first behind a
device-side sleep, so that the events read the device alone; beside them
the plain version's host-issued `plain_ms` (all but mg), torch's
scaled_dot_product_attention with the same mask (a yardstick, not on the
path), forward and backward together and the forward alone, their
difference `library_bwd_device_ms`, the bound of `flash_attn.bwd_work`
(operations at 3xTF32's 165 TFLOP/s in float32 and 989 in bf16, or bytes
at 3.35 TB/s) and the share of it in device time, each kernel's device
time from a profiler trace (`passes_ms`, by kernel name), and the
kernels' registers and spills from their build.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# case: (BH, S, Dh, group, heads a batch row, causal, window, prefix,
# dtypes)
CASES = {"mg": (96, 512, 64, 1, 12, False, 0, 0, ("float32", "bfloat16")),
         "local": (20, 512, 256, 10, 10, True, 2048, 0, ("bfloat16",)),
         "prefix": (16, 768, 256, 8, 8, True, 0, 256, ("bfloat16",)),
         "f32": (8, 300, 256, 2, 4, True, 0, 0, ("float32",)),
         "local_f32": (20, 512, 256, 10, 10, True, 2048, 0, ("float32",)),
         "prefix_f32": (16, 768, 256, 8, 8, True, 0, 256, ("float32",))}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 495e12 / 3, "bfloat16": 989e12}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--case", choices=sorted(CASES), default="mg")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_attn_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fa
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

    def passes_ms(fn):
        """Device ms a call of each backward kernel, by name, from a
        torch.profiler trace of --reps calls."""
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(r"fa_bwd\w*?_kernel", e.key)
            if m:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                out[m.group(0)] = (out.get(m.group(0), 0.0)
                                   + us / 1e3 / args.reps)
        return out

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bh, s, dh, group, heads, causal, window, prefix, dtypes = \
        CASES[args.case]
    mask_kw = dict(causal=causal, window=window, prefix_len=prefix)
    out = {"tree": os.path.abspath(args.tree), "file": fa.__file__,
           "case": args.case,
           "shape": f"({bh}, {s}, {dh}) group {group} causal {causal} "
                    f"window {window} prefix {prefix}"}
    ok = True
    for dt in dtypes:
        dtype = getattr(torch, dt)
        q, do = (torch.randn((bh, s, dh), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((bh // group, s, dh), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        o = fa.launch(q, k, v, causal, window, prefix)
        args_ = (q, k, v, o, do, causal, window, prefix)
        got = fa.launch_bwd(*args_)
        again = fa.launch_bwd(*args_)
        want = ref.flash_attn_bwd(q, k, v, o, do, **mask_kw)
        torch.cuda.synchronize()
        rel = max(float((g.double() - w.double()).abs().max())
                  / max(1.0, float(w.double().abs().max()))
                  for g, w in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        exact = ref.flash_attn_bwd(*(x.double() for x in (q, k, v, o, do)),
                                   **mask_kw)
        f64 = {name: [float((a.double() - e).pow(2).mean().sqrt()
                            / e.pow(2).mean().sqrt())
                      for a, e in zip(g, exact)]
               for name, g in (("kernel", got), ("plain", want))}
        del got, again, want, exact
        # SDPA on (B, heads, S, Dh), k and v repeated to the heads, the
        # same mask as a boolean (True: kept)
        qs = q.reshape(-1, heads, s, dh).clone().requires_grad_()
        ks, vs = (x.reshape(-1, heads // group, s, dh)
                  .repeat_interleave(group, dim=1).clone().requires_grad_()
                  for x in (k, v))
        dos = do.reshape(-1, heads, s, dh)
        mask = None
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
            if window:
                mask = mask.triu(1 - window)
            mask[:, :prefix] = True

        def kernel():
            return fa.launch_bwd(*args_)

        def plain():
            return ref.flash_attn_bwd(q, k, v, o, do, **mask_kw)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                (qs, ks, vs), dos)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=mask)
        ops, nbytes = fa.bwd_work((bh, s, dh), bh // group, dtype, causal,
                                  window, prefix)
        bound = max(ops / PEAK_OPS_S[dt], nbytes / PEAK_BYTES_S) * 1e3
        r = {"ms": ms(kernel), "device_ms": ms(kernel, queued=True),
             "library_ms": ms(sdpa_fwd_bwd),
             "library_device_ms": ms(sdpa_fwd_bwd, queued=True),
             "library_fwd_device_ms": ms(sdpa_fwd, queued=True),
             "bound_ms": bound, "rel_err": rel,
             "within_tolerance": rel <= TOL[dt], "bitwise_repeat": bitwise,
             "rms_err_vs_float64": f64}
        if args.case != "mg":
            r["plain_ms"] = ms(plain)
        r["library_bwd_device_ms"] = (r["library_device_ms"]
                                      - r["library_fwd_device_ms"])
        r["passes_ms"] = passes_ms(kernel)
        r["bound_share"] = bound / r["device_ms"]
        out[dt] = r
        ok = ok and r["within_tolerance"] and bitwise
    out["build"] = {fn: e for fn, e in build.ptxas_entries(
        build.ptxas_log("flash_attn_bwd")).items() if "fa_bwd" in fn}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
