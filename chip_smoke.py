#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the private sieve on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device and build: the card's name and power limit, the CUDA device
     count, and an nvcc build of every kernel from src/repro_torch/kernels/
     csrc/ (one nvcc per source, all started together) with its
     `-Xptxas -v` register / shared-memory / spill lines;
  2. every kernel against its plain torch version on the card, int32 and
     int64, at the main path's shapes plus ragged and broadcast-batch
     shapes: results must be bitwise equal; each is timed with CUDA events
     beside its plain version and its roofline bound;
  3. the main path: the two-phase private sieve at BERT-base width
     (d_model 768, 12 heads, d_head 64; proxies <1,1,2> then <3,12,16>;
     batch 4, seq 512, 2 classes; a pool of 64 candidates from --seed,
     keeping 24 then 8) through `WaveExecutor.score_phase` (wave 4,
     coalesced, overlapped, fused) and `quickselect.top_k_indices`, on
     RING32 and RING64. Every phase must satisfy `PhaseReport.agrees()`,
     launch the kernels and never take a plain version. One RING64
     phase-2 wave is then profiled (torch.profiler): device busy share,
     the GEMM kernels' time and the bitwise (threefry) kernels' time;
  4. the card against the CPU: one batch of the phase-2 forward with the
     same keys on both — shares must be bitwise equal on both rings
     (depth cut to CPU_LAYERS to bound the CPU's time; widths stay
     full);
  5. clear against MPC: the max |decoded MPC - clear entropy| per ring
     over the phase-2 candidates (printed, not gated).

The last lines are the card's `nvidia-smi` name and power limit, one
`{"kernels": [...]}` JSON line, and the result line
`{"ok": true, "device": {...}}`. Weights are random, made from --seed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and
# 67 T/s, the float32 rate of the CUDA cores outside the tensor cores;
# the sheet lists no integer CUDA-core rate, and int32/int64 multiply-
# adds run on the same cores (int64 emulated), so 67 T/s bounds them
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

DEVICE = "cuda"
RING_MATMUL_TPU = "src/repro/mpc/protocols/additive2pc.py:71"
SECURE_MATMUL_TPU = "src/repro/kernels/secure_matmul.py:60"


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *args, reps: int = 10) -> float:
    """Mean device time of fn(*args) over `reps` launches (after warm-up)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rand_ring(gen, shape, dtype, device):
    import torch
    lo, hi = (-2 ** 31, 2 ** 31) if dtype == torch.int32 else \
        (-2 ** 63, 2 ** 63 - 1)
    return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                         device=device)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_build() -> str:
    import torch
    from repro_torch.kernels import build
    smi = nvidia_smi()
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"({torch.cuda.get_device_name(0)})")
    t0 = time.time()
    logs = build.build()
    log(f"[1] built {sorted(build.SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[1] ptxas {name}: {line.strip()}")
    for name in build.SOURCES:
        build.lib(name)
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rmm_cases(dt):
    """(label, a shape, b shape, broadcast b over the batch)."""
    L = 4                                   # wave lanes
    return [
        ("scores eb", (2 * L * 48, 512, 64), (2 * L * 48, 64, 512), False),
        ("probs@v", (L * 48, 512, 512), (L * 48, 512, 64), False),
        ("proj", (L, 2048, 768), (L, 768, 768), False),
        ("mlp_sm w1", (L, 24576, 512), (L, 512, 16), False),
        ("mlp_ln w1 (K=1)", (L, 2048, 1), (L, 1, 16), False),
        ("mlp_ln w2 (N=1)", (L, 2048, 16), (L, 16, 1), False),
        ("ragged", (3, 67, 45), (3, 45, 131), False),
        ("broadcast weight", (5, 130, 70), (5, 70, 33), True),
    ]


def _smm_cases():
    """(label, batch, M, K, N, broadcast dlt/b over the batch)."""
    L = 4
    return [
        ("proj combine", L, 2048, 768, 768, False),
        ("mlp_sm w1 combine", L, 24576, 512, 16, False),
        ("mlp_sm w2 combine", L, 24576, 16, 512, False),
        ("mlp_ln combine (K=1)", L, 2048, 1, 16, False),
        ("ragged", 3, 67, 45, 131, False),
        ("broadcast weight", 5, 130, 70, 33, True),
    ]


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _max_err(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_matmul as rmm
    from repro_torch.kernels import secure_matmul as smm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # torch's own integer matmul on the card — the library yardstick
    probe = torch.ones((2, 2), dtype=torch.int32, device=dev)
    try:
        torch.matmul(probe, probe)
        lib_msg = None
    except RuntimeError as e:
        lib_msg = str(e).splitlines()[0]
    log(f"[2] torch.matmul on CUDA int32: "
        f"{'raises: ' + lib_msg if lib_msg else 'works'}")
    out = {"library_error": lib_msg, "ring_matmul": {}, "secure_matmul": {}}
    n0 = {"ring_matmul": rmm.stats()["kernel"],
          "secure_matmul": smm.stats()["kernel"]}
    for dt in (torch.int32, torch.int64):
        tag = str(dt).replace("torch.", "")
        for label, sa, sb, bcast in _rmm_cases(dt):
            a = rand_ring(gen, sa, dt, dev)
            b = rand_ring(gen, (1,) + sb[1:] if bcast else sb, dt, dev)
            if bcast:
                b = b.expand(sb)
            got = rmm.launch(a, b)
            want = ref.matmul_by_chunks(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"ring_matmul {tag} {label}: kernel != plain "
                     f"(max err {_max_err(got, want)})")
            log(f"[2] ring_matmul {tag} {label} {sa}@{sb}: bitwise equal")
            if label == "scores eb":
                bt, m, k = sa
                n = sb[-1]
                ms = cuda_ms(rmm.launch, a, b)
                plain_ms = cuda_ms(ref.matmul_by_chunks, a, b, reps=2)
                e = a.element_size()
                bound, by = _bound_ms((bt * m * k + bt * k * n + bt * m * n)
                                      * e, 2.0 * bt * m * n * k)
                out["ring_matmul"][tag] = {
                    "shape": f"{sa}@{sb}", "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0}
                log(f"[2] ring_matmul {tag} {label}: {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        for label, bt, m, k, n, bcast in _smm_cases():
            eps = rand_ring(gen, (bt, m, k), dt, dev)
            a_sh = rand_ring(gen, (2, bt, m, k), dt, dev)
            c_sh = rand_ring(gen, (2, bt, m, n), dt, dev)
            if bcast:
                dlt = rand_ring(gen, (1, k, n), dt, dev).expand(bt, k, n)
                b_sh = rand_ring(gen, (2, 1, k, n), dt, dev).expand(
                    2, bt, k, n)
            else:
                dlt = rand_ring(gen, (bt, k, n), dt, dev)
                b_sh = rand_ring(gen, (2, bt, k, n), dt, dev)
            args = (eps, dlt, a_sh, b_sh, c_sh)
            got = smm.launch(*args)
            want = smm.secure_matmul_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"secure_matmul {tag} {label}: kernel != plain "
                     f"(max err {_max_err(got, want)})")
            log(f"[2] secure_matmul {tag} {label} b{bt} {m}x{k}x{n}: "
                f"bitwise equal")
            if label == "proj combine":
                ms = cuda_ms(smm.launch, *args)
                plain_ms = cuda_ms(smm.secure_matmul_plain, *args, reps=2)
                e = eps.element_size()
                nbytes = (3 * bt * m * k + 3 * bt * k * n + 4 * bt * m * n) \
                    * e
                bound, by = _bound_ms(nbytes, 8.0 * bt * m * n * k)
                out["secure_matmul"][tag] = {
                    "shape": f"b{bt} {m}x{k}x{n}", "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": 0.0}
                log(f"[2] secure_matmul {tag} {label}: {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    out["check_launches"] = {
        "ring_matmul": rmm.stats()["kernel"] - n0["ring_matmul"],
        "secure_matmul": smm.stats()["kernel"] - n0["secure_matmul"]}
    log(f"[2] launches in this phase (not the main path's): "
        f"{out['check_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

PHASES = ((1, 1, 2), (3, 12, 16))
CPU_LAYERS = 1                 # phase-2 depth of the card-vs-CPU check
POOL, KEEPS, BATCH, SEQ, CLASSES, WAVE = 64, (24, 8), 4, 512, 2, 4


def build_proxies(seed: int, cfg=None):
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.proxy import ProxySpec, random_proxy
    cfg = BERT if cfg is None else cfg
    gen = torch.Generator().manual_seed(seed)
    specs = [ProxySpec(*p) for p in PHASES]
    pps = [random_proxy(gen, cfg, s, SEQ, CLASSES, device=DEVICE)
           for s in specs]
    return cfg, specs, pps


def phase_sieve(seed: int, proxies) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.kernels import ops as kops
    from repro_torch.mpc import prng, quickselect
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.mpc.sharing import reconstruct
    cfg, specs, pps = proxies
    pool = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (POOL, SEQ))
    results = {}
    kops.reset_smm_stats()
    kops.reset_rmm_stats()
    for ring in (RING32, RING64):
        surviving = np.arange(POOL)
        phases = []
        for pi, (spec, pp, keep) in enumerate(zip(specs, pps, KEEPS)):
            torch.cuda.reset_peak_memory_stats()
            ex = WaveExecutor(ExecConfig(wave=WAVE, coalesce=True,
                                         overlap=True, fuse=True,
                                         batch=BATCH, ring=ring,
                                         device=DEVICE))
            t0 = time.time()
            ent = ex.score_phase(prng.key(seed + 10 * pi, device=DEVICE),
                                 pp, cfg,
                                 pool[surviving], spec)
            top = quickselect.top_k_indices(ent, keep, seed=1234 + pi,
                                            wave=WAVE)
            vals = reconstruct(ent).double() / ring.scale
            appraisal = float(vals[torch.as_tensor(top, device=vals.device)]
                              .mean())
            torch.cuda.synchronize()
            wall = time.time() - t0
            rep = ex.reports[-1]
            d = rep.device
            name = f"{ring.name} phase{pi + 1} <{spec.n_layers},{spec.n_heads},{spec.mlp_dim}>"
            if not rep.agrees():
                fail(f"{name}: ledger does not agree with the schedule")
            if d.matmul_kernel <= 0 or (ring.bits == 32
                                        and d.combine_kernel <= 0):
                fail(f"{name}: kernels not launched ({d.as_dict()})")
            if d.matmul_ref or d.combine_ref:
                fail(f"{name}: a plain version ran on the card "
                     f"(matmul_ref {d.matmul_ref}, combine_ref "
                     f"{d.combine_ref})")
            if ent.sh.shape != (2, len(surviving)):
                fail(f"{name}: scores of shape {tuple(ent.sh.shape)}")
            if not torch.isfinite(vals).all():
                fail(f"{name}: non-finite scores")
            led = rep.ledger
            info = {
                "candidates": len(surviving), "keep": keep,
                "rounds": led.rounds, "lat_rounds": led.lat_rounds,
                "bw_rounds": led.bw_rounds, "nbytes": led.nbytes,
                "offline_nbytes": led.offline_nbytes,
                "score_wall_s": rep.wall_s, "phase_wall_s": wall,
                "device_makespan_s": rep.device_makespan_s,
                "matmul_kernel": d.matmul_kernel,
                "combine_kernel": d.combine_kernel,
                "appraisal": appraisal,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
            surviving = np.sort(surviving[top])
            info["survivors"] = surviving.tolist()
            phases.append(info)
            log(f"[3] {name}: " + json.dumps(info))
            if pi == 1:
                results[ring.name] = {"phases": phases, "scores": ent,
                                      "candidates": pool[np.sort(
                                          phases[0]["survivors"])]}
    launches = {"ring_matmul": kops.rmm_stats()["kernel"],
                "secure_matmul": kops.smm_stats()["kernel"]}
    plain = kops.rmm_stats()["ref"] + kops.smm_stats()["ref"]
    log(f"[3] main-path launches {launches}, plain-version calls {plain}")
    if min(launches.values()) <= 0 or plain:
        fail("main path did not run through every kernel")
    results["launches"] = launches
    return results


def phase_profile(seed: int, proxies) -> dict:
    """Where one phase-2 wave's device time goes: one RING64 wave of WAVE
    batches under torch.profiler (CUDA activity only: the CPU side adds
    an event per aten op and multiplies the trace), after the main
    path's launch counts were read. Busy share = summed kernel time /
    wall time of the wave (one stream, so kernels do not overlap). The
    bitwise kernels (xor/and/or functors and shifts) are nearly all the
    threefry hash's; its adds, shared with the Beaver arithmetic, are
    not split out."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING64
    cfg, specs, pps = proxies
    pool = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (WAVE * BATCH, SEQ))
    ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=RING64,
                                 device=DEVICE))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        ex.score_phase(prng.key(seed + 5, device=DEVICE), pps[1], cfg,
                       pool, specs[1])
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    def share(*words):
        return sum(ms(e) for e in kernels if any(w in e.key for w in words))

    busy = sum(ms(e) for e in kernels)
    out = {"wave_wall_ms": wall_ms, "kernel_ms": busy,
           "busy_share": busy / wall_ms,
           "gemm_kernels_ms": share("ring_matmul_kernel",
                                    "secure_matmul_kernel"),
           "bitwise_kernels_ms": share("Bitwise", "shift_kernel"),
           "top": [(e.key[:100], ms(e), e.count) for e in
                   sorted(kernels, key=ms, reverse=True)[:6]]}
    log(f"[3p] ring64 one phase-2 wave ({WAVE} batches, profiled): "
        + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(seed: int, proxies) -> None:
    import numpy as np
    import torch
    from repro_torch.core.proxy import ProxySpec, share_proxy, tree_leaves, \
        tree_rebuild
    from repro_torch.engine import MPCEngine, proxy_entropy
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.mpc.sharing import Share, share
    cfg, specs, pps = proxies
    spec = ProxySpec(CPU_LAYERS, *PHASES[1][1:])
    pp = dict(pps[1])
    pp["attn"] = {k: v[:CPU_LAYERS] for k, v in pp["attn"].items()}
    for k in ("ln_scale", "ln_bias"):
        pp[k] = pp[k][:CPU_LAYERS]
    for k in ("mlp_sm", "mlp_ln"):
        pp[k] = pp[k][:CPU_LAYERS]
    del pp["embed"]
    tok = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size,
                                                   (BATCH, SEQ))
    x = pps[1]["embed"][torch.as_tensor(tok, device=DEVICE)] \
        * float(np.float32(cfg.d_model ** 0.5))
    for ring in (RING32, RING64):
        key = prng.key(seed + 77, device=DEVICE)
        pp_sh = share_proxy(prng.fold_in(key, 1), pp, ring)
        x_sh = share(prng.fold_in(key, 2), x, ring)
        out = {}
        for dev in (DEVICE, "cpu"):
            d = torch.device(dev)
            psh = tree_rebuild(pp_sh, [s.with_sh(s.sh.to(d))
                                       for s in tree_leaves(pp_sh)])
            eng = MPCEngine(ring).with_key(prng.fold_in(key, 3).to(d))
            t0 = time.time()
            ent = proxy_entropy(eng, psh, cfg, Share(x_sh.sh.to(d), ring),
                                spec)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[dev] = ent.sh.cpu()
            log(f"[4] {ring.name} <{spec.n_layers},{spec.n_heads},"
                f"{spec.mlp_dim}> forward on {dev}: "
                f"{time.time() - t0:.1f} s")
        if not torch.equal(out[DEVICE], out["cpu"]):
            fail(f"{ring.name}: card and CPU shares differ "
                 f"({int((out[DEVICE] != out['cpu']).sum())} elements)")
        log(f"[4] {ring.name}: card == CPU, bitwise "
            f"({tuple(out['cpu'].shape)} shares)")


# ---------------------------------------------------------------------------
# phase 5: clear against MPC
# ---------------------------------------------------------------------------

def phase_clear_vs_mpc(proxies, sieve) -> dict:
    import torch
    from repro_torch.engine import ClearEngine, proxy_entropy
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.mpc.sharing import reconstruct
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, specs, pps = proxies
    errs = {}
    for ring in (RING32, RING64):
        res = sieve[ring.name]
        tok = torch.as_tensor(res["candidates"], device=DEVICE)
        clear = torch.cat([proxy_entropy(ClearEngine(), pps[1], cfg,
                                         tok[i:i + BATCH], specs[1])
                           for i in range(0, len(tok), BATCH)])
        mpc = ring.decode(reconstruct(res["scores"]))
        errs[ring.name] = float((mpc.double() - clear.double()).abs().max())
        log(f"[5] {ring.name}: max |MPC - clear| entropy over "
            f"{len(tok)} phase-2 candidates = {errs[ring.name]:.6g}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1

    t_all = time.time()
    smi = phase_build()
    kern = phase_kernels(args.seed)
    proxies = build_proxies(args.seed)
    t0 = time.time()
    sieve = phase_sieve(args.seed, proxies)
    log(f"[3] sieve on both rings: {time.time() - t0:.1f} s")
    phase_profile(args.seed, proxies)
    t0 = time.time()
    phase_card_vs_cpu(args.seed, proxies)
    log(f"[4] card vs CPU: {time.time() - t0:.1f} s")
    errs = phase_clear_vs_mpc(proxies, sieve)

    kernels = []
    for name, src, tpu in (
            ("ring_matmul", "src/repro_torch/kernels/csrc/ring_matmul.cu",
             RING_MATMUL_TPU),
            ("secure_matmul",
             "src/repro_torch/kernels/csrc/secure_matmul.cu",
             SECURE_MATMUL_TPU)):
        k32, k64 = kern[name]["int32"], kern[name]["int64"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sieve["launches"][name],
            "max_abs_err": max(k32["max_abs_err"], k64["max_abs_err"]),
            "ms": k32["ms"], "plain_ms": k32["plain_ms"],
            "bound_ms": k32["bound_ms"], "bound_by": k32["bound_by"],
            "library_ms": None,
            "library_note": f"torch has no CUDA int32/int64 matmul "
                            f"({kern['library_error']})",
            "shape": k32["shape"], "dtype": "int32", "int64": k64})
    log(f"[5] clear-vs-MPC max abs error: {json.dumps(errs)}")
    log(f"total {time.time() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
