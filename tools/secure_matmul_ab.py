#!/usr/bin/env python3
"""Time the secure_matmul kernel of one checkout of this repository at
the main path's combines, on both rings, on one NVIDIA GPU:

    python3 tools/secure_matmul_ab.py --tree DIR [--reps 30] [--wave]

DIR is the root of a checkout (this one by default); its
src/repro_torch/kernels/secure_matmul.py is imported and its kernel built
from its own sources. The cases are the private sieve's phase-2 combines
at BERT width in a wave of 4 lanes (chip_smoke.py phase 2): a projection
b4 x 2048x768 @ 768x768 and the MLP's two layers, b4 x 24576x512 @ 512x16
and b4 x 24576x16 @ 16x512, each in int32 and int64, inputs from --seed.
Each result is checked bitwise against the plain version. At the
projection it also times the unfused route that RING64 takes
(mpc/protocols/additive2pc.py: three ring_matmul launches and the adds),
on the same inputs, through the checkout's own ring_matmul. `--wave`
profiles one RING32 phase-2 wave of the sieve (proxy <3,12,16>, batch 4,
seq 512, 4 lanes, random weights from --seed) and reports the kernel
time of secure_matmul in it. To compare two trees, run it in one call on
one card, in turns (A, B, B, A). It prints the card's name and power
limit and one JSON line of mean CUDA-event times in ms: `ms` with the
host issuing each call as the program would, `device_ms` with every
launch queued first behind a device-side sleep, so that the events read
the device alone.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CASES = (  # (name, batch, M, K, N)
    ("proj combine", 4, 2048, 768, 768),
    ("mlp_sm w1 combine", 4, 24576, 512, 16),
    ("mlp_sm w2 combine", 4, 24576, 16, 512))


def profile_wave(seed: int) -> dict:
    """One RING32 phase-2 wave under torch.profiler (CUDA activity)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.core.proxy import ProxySpec, random_proxy
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32
    wave, batch, seq = 4, 4, 512
    spec = ProxySpec(3, 12, 16)
    pp = random_proxy(torch.Generator().manual_seed(seed), BERT, spec, seq,
                      2, device="cuda")
    pool = np.random.default_rng(seed + 2).integers(
        0, BERT.vocab_size, (wave * batch, seq))
    ex = WaveExecutor(ExecConfig(wave=wave, batch=batch, ring=RING32,
                                 device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        ex.score_phase(prng.key(seed + 5, device="cuda"), pp, BERT, pool,
                       spec)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    smm = [e for e in events if "secure_matmul_kernel" in e.key]
    return {"wave_wall_ms": wall_ms,
            "kernel_ms": sum(ms(e) for e in events),
            "secure_matmul_ms": sum(ms(e) for e in smm),
            "secure_matmul_launches": sum(e.count for e in smm),
            "ring_matmul_ms": sum(ms(e) for e in events
                                  if "ring_matmul_kernel" in e.key)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wave", action="store_true",
                    help="also profile one RING32 phase-2 wave")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("secure_matmul_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import ring_matmul as rmm
    from repro_torch.kernels import secure_matmul as smm

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

    def unfused(eps, dlt, a_sh, b_sh, c_sh):
        eb = rmm.ring_matmul(eps.expand((2,) + tuple(eps.shape)), b_sh)
        ad = rmm.ring_matmul(a_sh, dlt.expand((2,) + tuple(dlt.shape)))
        z = c_sh + eb + ad
        ed = rmm.ring_matmul(eps, dlt)
        return torch.cat([(z[0] + ed).unsqueeze(0), z[1:]])

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"tree": os.path.abspath(args.tree), "file": smm.__file__}
    for dt in (torch.int32, torch.int64):
        info = torch.iinfo(dt)
        for name, bt, m, k, n in CASES:
            xs = [torch.randint(info.min, info.max, s, generator=gen,
                                dtype=dt, device="cuda")
                  for s in ((bt, m, k), (bt, k, n), (2, bt, m, k),
                            (2, bt, k, n), (2, bt, m, n))]
            want = smm.secure_matmul_plain(*xs)
            t = {"ms": ms(lambda: smm.launch(*xs)),
                 "device_ms": ms(lambda: smm.launch(*xs), queued=True),
                 "bitwise_equal": torch.equal(smm.launch(*xs), want)}
            if name == "proj combine":
                t["unfused_ms"] = ms(lambda: unfused(*xs))
                t["unfused_device_ms"] = ms(lambda: unfused(*xs),
                                            queued=True)
                t["unfused_bitwise_equal"] = torch.equal(unfused(*xs), want)
            out[f"{name} {str(dt)[6:]}"] = t
            del xs, want
    if args.wave:
        out["ring32 wave"] = profile_wave(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps(out))
    return 0 if all(v.get(key, True) for v in out.values()
                    if isinstance(v, dict)
                    for key in ("bitwise_equal",
                                "unfused_bitwise_equal")) else 1


if __name__ == "__main__":
    sys.exit(main())
