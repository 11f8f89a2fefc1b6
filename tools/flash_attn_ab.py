#!/usr/bin/env python3
"""Time the flash_attn kernel of one checkout of this repository at the
two main-path cases, beside torch's scaled_dot_product_attention, on one
NVIDIA GPU:

    python3 tools/flash_attn_ab.py --tree DIR [--reps 200]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/flash_attn.py is imported and its kernel built
from its own sources. The cases are the Oracle's attention batch, q/k/v
(192, 512, 64) float32, non-causal (chip_smoke.py phase 6a), and a
RecurrentGemma prefill batch, q (40, 512, 256) over k/v (4, 512, 256),
bfloat16, causal with a window of 2048 (phase 7). Inputs come from
--seed. To compare two trees, run it in one call on one card, in turns
(A, B, B, A). It prints the card's name and power limit and one JSON
line of mean CUDA-event times in ms: `*_ms` with the host issuing each
call as the program would, `*_device_ms` with every launch queued first
behind a device-side sleep, so that the events read the device alone.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = (  # (name, BH, S, Dh, group, dtype, causal, window)
    ("oracle_f32", 192, 512, 64, 1, "float32", False, 0),
    ("recurrentgemma_bf16", 40, 512, 256, 10, "bfloat16", True, 2048))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_attn_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ref

    def ms(fn, queued=False):
        for _ in range(5):
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
    out = {"tree": os.path.abspath(args.tree), "file": fa.__file__}
    for name, bh, s, dh, group, dt, causal, window in CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for shape in ((bh, s, dh),
                                            (bh // group, s, dh),
                                            (bh // group, s, dh)))
        got = fa.launch(q, k, v, causal, window)
        want = ref.flash_attn(q, k, v, causal=causal, window=window)
        err = float((got.double() - want.double()).abs().max())
        qs, ks, vs = (x.reshape(-1, g, s, dh)
                      for x, g in ((q, group), (k, 1), (v, 1)))

        def kernel():
            return fa.launch(q, k, v, causal, window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=group > 1)
        out[name] = {"kernel_ms": ms(kernel), "sdpa_ms": ms(sdpa),
                     "kernel_device_ms": ms(kernel, queued=True),
                     "sdpa_device_ms": ms(sdpa, queued=True),
                     "max_abs_err_vs_plain": err}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
