#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: the private sieve, the
clear scoring paths, token serving, the selection pipeline, the
exact-op MPC baselines, the appraisal service, the other protocol
backends, the real wire and the model zoo's training.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device and build: the card's name and power limit, the CUDA device
     count, and an nvcc build of every kernel from src/repro_torch/kernels/
     csrc/ (one nvcc per source, all started together) with its
     `-Xptxas -v` register / shared-memory / spill lines; then the
     witness that flash_attn runs on the tensor cores: `cuobjdump -sass`
     of its library must show HGMMA in every instantiation (bf16 and
     float32, Dh 16-256), and the path's two (bf16 Dh 256, float32 Dh
     64) must not spill; and that ring_matmul runs on the int8 tensor
     cores: IGMMA in every instantiation (int32 and int64, each at its
     two tile widths), none spilling, and so does secure_matmul (int32
     and int64, each at its two tile widths); and that ssd runs on the
     tensor cores: HGMMA in both instantiations (bf16 and float32), the
     path's (bf16) not spilling; and mlp_softmax_attn's eight
     instantiations' registers and spills, the path's (float32 Dh 64)
     not spilling and none holding an atomic in its SASS (A is summed
     across the cluster in rank order); and rg_lru's registers and
     spills, neither spilling nor holding an atomic (the chunks' carries
     are folded in warp order); and entropy_head's six instantiations'
     registers and spills (one thread a row, and a row split across a
     block or a cluster, each in float32, bf16 and f16), the path's
     (float32) not spilling and none holding an atomic (the (m, z, s)
     triples are merged in a fixed order);
  2. every kernel against its plain torch version on the card: the ring
     kernels on int32 and int64, at the main path's shapes plus ragged and
     broadcast-batch shapes, bitwise (both also with every limb 0xFF at
     K = K_CHUNK and a K past it; ring_matmul also with INT_MIN /
     INT_MAX operands, secure_matmul with rows off a 16-byte boundary); the
     float kernels (flash_attn,
     entropy_head, mlp_softmax_attn) at the clear paths' shapes plus
     ragged, causal and bfloat16 ones, within 1e-4 (attention) and 1e-5
     (entropy) of max |plain| in float32. Each is timed with CUDA events
     beside its plain version, its roofline bound and, for flash_attn,
     torch's scaled_dot_product_attention (a yardstick, not on the path).
     flash_attn is timed at both path cases in the path's dtype: the
     Oracle's (192, 512, 64) float32, bound against 3xTF32's 165 TFLOP/s
     (the CUDA cores' 67 beside it), and RecurrentGemma's prefill (40,
     512, 256) bfloat16, against 989 TFLOP/s, bytes counted at the
     element size (`flash_attn.work`). ring_matmul is timed at its four
     path cases on both rings, host-issued and queued, against its u8
     limb products at the int8 tensor cores' 1,979 TOP/s or its bytes
     (`ring_matmul.work`), the CUDA cores' 67 T/s bound beside it.
     secure_matmul is timed the same way at its path case, the projection
     combine b4 x 2048x768 @ 768x768, on both rings (`secure_matmul.work`),
     beside the unfused route that RING64 takes (three ring_matmul
     launches and the adds, mpc/protocols/additive2pc.py). ssd
     adds hard cases (no decay, decays that underflow, a large initial
     state, chunk 1, P, N and T of 1) and is timed at Mamba-2's prefill
     batch in bf16, host-issued and queued, against its bytes or its
     products at 989 TFLOP/s (`ssd.work`), the CUDA cores' bound beside
     it, and in float32 against 3xTF32's rate. mlp_softmax_attn adds
     the cluster's hard cases (Sq 1024, Sq 1 and 8, Skv 450, hid 64,
     Dh 16 and 128 in bf16, a permuted q), checks that two launches are
     bitwise equal, and is timed at the clear sieve's two cases,
     host-issued and queued, against the bytes of
     `mlp_softmax_attn.work`, the score form's operations bound (the
     parent kernel's) beside it. rg_lru adds the chunked scan's hard
     cases (T 1 and 129, D 1 and 33, a = 1, a = 0, the model's gate
     range, a large initial state, permuted operands), checks that two
     launches are bitwise equal, and is timed at RecurrentGemma's prefill
     batch host-issued, queued, and queued over four copies of its inputs
     (which outrun the L2 cache), against the bytes of `rg_lru.work`.
     entropy_head adds the split kernel's hard cases (V 1 and 3, V
     30521, one row, few rows in clusters of 4 and 8, 65536 rows of 2,
     logits of scale 1e4, all-equal rows, a transposed-then-sliced view,
     bf16 and f16 rows off 16 bytes), checks that two launches are
     bitwise equal, and is timed at the Oracle's (16, 2) and at the
     vocabulary-wide (256, 30522) float32, host-issued, queued and queued
     over four copies, against the bytes of `entropy_head.work`, beside
     the plain version and torch.distributions.Categorical's entropy (a
     yardstick, not on the path);
  3. the main path: the two-phase private sieve at BERT-base width
     (d_model 768, 12 heads, d_head 64; proxies <1,1,2> then <3,12,16>;
     batch 4, seq 512, 2 classes; a pool of 64 candidates from --seed,
     keeping 24 then 8) through `WaveExecutor.score_phase` (wave 4,
     coalesced, overlapped, fused) and `quickselect.top_k_indices`, on
     RING32 and RING64. Every phase must satisfy `PhaseReport.agrees()`,
     launch the kernels and never take a plain version. One phase-2
     wave of each ring is then profiled (torch.profiler): device busy
     share, the GEMM kernels' time, secure_matmul's (RING32) and the
     bitwise (threefry) kernels' time;
  4. the card against the CPU: CPU_ROWS rows of the phase-2 forward
     with the same keys on both — shares must be bitwise equal on both
     rings (depth cut to CPU_LAYERS and rows to CPU_ROWS to bound the
     CPU's time; widths stay full);
  5. clear against MPC: the max |decoded MPC - clear entropy| per ring
     over the phase-2 candidates (printed, not gated);
  6. the clear scoring paths at full width: (a) the BERT-base target
     (12 layers, d_model 768, vocab 30,522, 2 classes, random weights
     from --seed) scores a 64-candidate pool by prediction entropy in
     batches of 16 and keeps the top 8 (the Oracle), then reads its
     accuracy on 64 test examples — flash_attn once a layer a batch,
     entropy_head once a scored batch, no plain version; one batch at
     depth 1 then agrees with the CPU; (b) the two-phase clear sieve
     (ClearEngine, full MLP variant, the phase-3 proxies, 64 -> 24 -> 8,
     batch 4) — mlp_softmax_attn once a layer a batch; one phase-2 batch
     agrees with the CPU; its survivors' overlap with the MPC sieve's is
     printed. Each is profiled (torch.profiler, CUDA activity): wall and
     device kernel time, and mlp_softmax_attn's share of the latter;
  7. token serving at full width: mamba2_2_7b (64 SSD layers, d_model
     2560) and then recurrentgemma_2b (26 layers: 18 RG-LRU, 8 local
     attention with d_head 256 over one kv head), random weights from
     --seed on the card, through the port's `launch.serve.Server`: 8
     requests of 512-token prompts on 4 slots, 16 new tokens each (two
     prefill batches, 15 decode steps each). Prefill launches ssd, or
     rg_lru and flash_attn (Dh 256), once a layer a batch and no plain
     version; tok/s, prefill and decode wall, peak memory; one prefill
     batch and one decode step profiled; the card against the CPU on one
     request (prefill and 4 decode steps' logits, depth cut to one layer
     or one block pattern, float32) within 1e-4 of max |CPU|. Phase 2
     also checks and times ssd (with its final state), rg_lru and
     flash_attn at Dh 256;
  7b. the rest of the model zoo's serving path at full width and depth,
     random weights from --seed on the card: qwen2_0_5b (dense) and
     granite_moe_3b (moe, 40 experts top-8) through `Server`, 4 requests
     of 512-token prompts on 4 slots, 8 new tokens; qwen2_0_5b again
     with an int8 KV cache, prefill and 4 teacher-forced decode steps
     held to the JAX package's own gate against the bf16 teacher-forced
     logits (correlation > 0.99, max |diff| < 0.2); paligemma_3b (vlm: 4
     rows of 256 stub patches + 512 tokens, the prefix mask) and
     whisper_small (encdec: 4 rows of 1,500 stub frames and a 64-token
     prompt) through `T.prefill` and 7 greedy `T.decode_step`s. Each run
     launches flash_attn once an attention layer (whisper: encoder,
     decoder and cross-attention) and no plain version, gives finite
     logits and tokens inside the vocabulary; tok/s, walls, peak memory,
     one profiled prefill batch and decode step; the card against the
     CPU on one row (depth 1, float32, prefill and 4 decode steps) within
     1e-4 of max |CPU|. Phase 2 also checks flash_attn's prefix mask
     (PaliGemma's (32, 768, 256), group 8, prefix 256, timed, and prefixes
     of 0, 1, = S and past a key tile) and the cross case (Whisper's 48 x
     64 queries over 1,500 keys, timed, and float32), each timed beside
     SDPA with an explicit boolean mask;
  8. the paper's pipeline from `run_selection` down: a BERT-base target (full
     depth and width, random from --seed), a pool of 64 at seq 512 (8
     bootstrap rows, a budget of 13), `two_phase_default(12)`. (8a)
     SelectionConfig's step counts (finetune 200, in-vivo 150; ex-vivo 300
     cut to 100 for time, A_STEPS), first in mode="clear", then in mode="mpc"
     on RING32 with phase 3's executor flags; M_g's finetune and phase 1's
     proxy (in-vivo losses, clear and decoded MPC scores) are held finite;
     from this random target the phase-2 proxy built by the ex-vivo fits is
     already non-finite, as the JAX package's is at this width (PERF.md,
     tools/selection_divergence.py), so phase 2's scores are reported, not
     held finite. (8b) The same with the finetune and in-vivo steps cut to 3
     (CUT_STEPS), below the divergence: finite scores, and the largest
     |decoded MPC - clear| entropy per phase for the trained proxies, on
     RING32 and with the same proxies rescored on RING64. Each stage's wall
     (M_g finetune, stats, ex-vivo fits, in-vivo, each sieve phase), its
     launch counts and the training stages' first and last losses are
     printed; fatal unless M_g's finetune launches flash_attn's backward
     kernel and in-vivo mlp_softmax_attn's, the fits entropy_head, the sieve
     its kernels, and no plain version runs. (8c) The card against the CPU on
     one finetune and one build_proxy + invivo_finetune at BERT width, depth
     1, 3 steps of batch 8: bootstrap and batch indices bitwise, losses and
     parameters within the CPU tests' tolerances, but for M_g's elements
     whose first gradient is below Adam's eps (ADAM_EPS). (8d) 8a's clear run
     resumed from its phase checkpoints: 2 phases, the same survivors and
     appraisal. Phase 1 also reports the backward kernels' registers, spills
     (none at float32 Dh 64) and atomics (none), and fails unless
     flash_attn's backward shows HGMMA in all sixteen instantiations; phase
     2 holds them against autograd of their plain versions (TOL, BF16_TOL),
     flash_attn's also at S off its tiles, every Dh in both types, a group
     of 10, a window whose first key tile is partial and inputs x 3, checks
     a second launch bitwise and times them, flash_attn's beside SDPA's
     forward and backward and its forward alone, in float32 and bf16.
     The training path's backward kernels too: phase 1 reports the
     registers, spills and atomics of flash_attn's Dh-256 passes and group
     sum, ssd's state, chunk and sum passes, bf16 and float32, and rg_lru's
     reverse recurrence, none holding an atomic and none spilling, and
     fails unless the passes with products show HGMMA in both types
     (flash_attn's dq and dk/dv at Dh 256, ssd's state and chunk passes;
     the sums are elementwise); phase 2 (`phase_train_kernels`) holds them
     against autograd of the plain versions: flash_attn at RecurrentGemma's
     (20, 512, 256) local layer (group 10, window 2048) and PaliGemma's (16,
     768, 256) prefix 256 (group 8), each in bf16 and float32, prefixes of
     0, 1, = S and past a key tile, Dh 256 in float32 at S off the 16-row
     tiles, a window whose first tile is partial and bidirectional, bf16 Dh
     256 at S off 64 with a group of 3, a window whose first tile is
     partial, a prefix past a tile and bidirectional, the prefix at Dh 64
     and 128; ssd at Mamba-2's (2, 512, 80, 64) bf16 and float32 with a
     forward chunk of 1, no decay, underflowing decays, an initial state x
     100 with its gradient, a final state's gradient, and in both types T
     off the chunk with heads off the chunk pass's group, P and N off the
     tiles (bf16 also P past one state slice); and rg_lru at (2, 512, 2560)
     with T 1 and 129, a = 0, a = 1 and permuted operands; each path case
     checked bitwise on a second launch and timed host-issued and queued
     beside its plain backward and its `bwd_work` bound, flash_attn's
     beside SDPA's backward with the same boolean mask.
  9. the exact-op MPC baselines, the analytic mirror and the launcher.
     (9a) Table 2's ablations (no-sm, no-ln, no-se) and Table 3's
     baselines (quad_sm: MPCFormer 2Quad; poly_sm: Bolt polynomial), each
     beside the full variant, through `WaveExecutor.score_phase` with
     phase 3's phase-2 proxy cut to one layer (<1,12,16>, VAR_LAYERS) and
     phase 3's executor flags over one wave of VAR_BATCHES batches of 4 at
     BERT-base width, on RING32 then RING64:
     each phase must agree with its schedule, launch secure_matmul
     (RING32) or ring_matmul (RING64), run no plain version and score
     finite; wall, makespan, rounds, bytes, peak memory and the max
     |decoded MPC - ClearEngine with the same variant| are printed (not
     gated: RING32's exp and the NR reciprocal may wrap). (9b) Each
     exact-op variant's forward on the card and the CPU with the same
     keys, one row at depth 1 and seq 128, on one ring (VAR_CPU_RING,
     the rings alternating): shares bitwise equal. (9c) `costs.proxy_exec_cost` against the meta probe record for
     record for phase 3's two proxies, eager and fused, both rings, and
     `schedule_search.grid_search(42000)`'s Pareto frontier. (9d)
     `launch.select.run(mode="mpc", ring_bits=32)` at its defaults: its
     phase ledgers agree, it buys the budget, and secure_matmul, the
     flash_attn forward and backward, the mlp_softmax_attn forward and
     backward and entropy_head launch with no plain version; accuracies,
     the selection wall and the paper-scale delays are printed.
 10. the appraisal service. (10a) `serve.AppraisalServer` on the card,
     dealer on (its material drawn on the card), with three sessions over
     phase 8's BERT-base target: s0 is 8b's MPC run exactly, s1 its twin,
     s2 the same target over a second pool (another data owner). Fatal
     unless s0's and s1's phase scores, survivors and appraisal are
     bitwise 8b's, s1 executed no MPC phase (served from the cache or by
     waiting on s0's in-flight phase: 4 of 6 phases executed), every
     session's ledger agrees and holds only its own flights, s2's phase-1
     scores decode finite, and secure_matmul, ring_matmul, the flash_attn
     and mlp_softmax_attn forward and backward and entropy_head launched
     with no plain version. The phase's and each session's wall, the
     modelled throughput at wan, the cache's and the dealer's counters
     (stall seconds, bytes produced), the peak device memory and each
     session's launches by kernel are printed. (10b)
     `launch.serve.appraise` at its defaults (TINY target, RING64): its
     ledgers agree, the cache hits, the kernels launch with no plain
     version.
 11. the other protocol backends. (11a) The executed sieve under
     replicated3pc on RING64 and aby3trunc and spdz2pc on both rings
     (3pc on RING32 is left out: its regrouped shift wraps), phase 3's
     phase-2 proxy <3,12,16> shared under each and phase 3's executor
     flags over one wave of VAR_BATCHES batches of 4: fatal unless each
     phase agrees with its schedule, its per-batch ledger equals
     `costs.proxy_exec_cost` record for record, the shares have 3 rows
     (4 for spdz2pc), the offline channel is empty for the dealer-free
     backends and not for spdz2pc, spdz2pc's ledger holds its sacrifice
     and MAC-check records, ring_matmul launched and secure_matmul did
     not, no plain version ran and the scores are finite; wall,
     makespan, rounds, bytes, peak memory, launches and max |decoded MPC
     - ClearEngine| are printed. (11b) One pair a backend
     (PROTO_CPU_PAIRS: 3pc RING64, aby3trunc RING32, spdz2pc RING64),
     its forward on the card and the CPU with the same keys, one row at
     depth 1 and seq 128: shares bitwise equal. (11c) One eager spdz2pc RING64 forward of a
     batch of 4 at 11a's width inside `mac_scope` passes the boundary
     MAC check (every obligation read), and 11b's small forward with
     one bit of a partial open flipped raises MacCheckError at
     `MPCEngine.entropy_head`.
 12. the real wire and recovery, one batch of 4 at seq 512 and BERT-base
     width (one wave), each proxy cut to depth 1 (WIRE_LAYERS), every
     wired phase beside the same phase unwired (`wire="none",
     coalesce=False`). (12a) phase 3's phase-2 proxy <1,12,16>, RING32
     2pc, fused, `wire="local"`: fatal unless the scores are bitwise the
     unwired run's, the ledger agrees, the per-batch ledger equals
     `costs.proxy_exec_cost` record for record, the replay's goodput
     equals the ledger's online bytes (0.871 GB) and every payload
     digest matches, and secure_matmul launched with no plain version;
     the tape's GB and flights, `wire_makespan_s`, the cost of capture
     (wired minus unwired score wall) and the peak device GB are
     printed. (12b) the same phase over `wire="socket"` at wan (one
     spawned process a party, paced localhost TCP), held to 12a's gates
     and scores; its `wire_makespan_s` beside the model's
     `makespan(WAN)` and their ratio (printed, not gated). (12c) phase
     3's phase-1 proxy <1,1,2>, RING32 2pc, socket at pod_dcn under
     `chaos_seed=123`: bitwise scores, bytes and digests, faults injected
     and retried, one respawn that recovered, `FaultPlan.from_tape` the
     same JSON twice; the plan and the RETRANS channel are printed.
     (12d) <1,1,2> under 3pc RING64, local, chaos and `degraded`: the
     report names one dead party, the bytes match the filtered tape, the
     scores are bitwise the unwired 3pc run's, ring_matmul launched with
     no plain version. (12e) 12c's forward at depth 1 and seq 128, one
     row, 2pc on both rings, captured on the card and the CPU with the
     same keys: the tapes equal message for message, `expected_digests`
     agree and the tape carries share bytes, not filler only.
 13. the model zoo's training. (13a) `launch.train.train` on qwen2_0_5b
     at full width and depth (24 layers, d_model 896, vocab 151,936,
     bf16 activations over float32 weights, grads and AdamW state), 16
     steps of 8 x 128 with remat and a checkpoint at step 16, then a
     second `train` to step 20: fatal unless the losses are finite, the
     last of the first run below its first, the second resumes from 16,
     flash_attn's forward and backward kernels launched and no plain
     version ran; the step wall, tokens/s, peak GB, the checkpoint's
     wall and one profiled step (busy share, top kernels, the backward
     kernel's share); the checkpoint directory is removed. (13b)
     `make_train_step`, 3 steps each at full width, depth cut
     (TRAIN_CUT): recurrentgemma_2b one (rec, rec, attn) pattern at 2 x
     512 (rg_lru's and flash_attn's Dh-256 windowed backward), mamba2_2_7b
     2 layers at 2 x 512 (ssd's), paligemma_3b 2 layers at 2 rows of 256
     stub patches + 512 tokens (the prefix backward): finite losses, the
     backward kernels launched, no plain version. (13c) One step's loss
     and gradients of each 13b family and qwen2_0_5b, the card against
     the CPU in float32 at depth 1 (one block pattern for the hybrid),
     one row of 32 tokens: the loss within 1e-4 of |CPU|, every gradient
     leaf within 1e-3 of that leaf's max |CPU|, the worst leaf printed.

The last lines are the card's `nvidia-smi` name and power limit, one
`{"kernels": [...]}` JSON line, and the result line
`{"ok": true, "device": {...}}`. Weights are random, made from --seed.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
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
# the tensor cores' dense bf16 rate, and 3xTF32's: three tf32 products
# (495 T/s) for each float32 one
PEAK_BF16_S = 989e12
PEAK_3XTF32_S = 495e12 / 3
# the tensor cores' dense int8 rate, which ring_matmul's u8 limb products
# run at
PEAK_INT8_S = 1979e12
# float kernels against their plain versions, of max(1, max |plain|):
# float32 attention (sums reassociated), float32 entropy, bfloat16 outputs
TOL, EH_TOL, BF16_TOL = 1e-4, 1e-5, 1e-2
# scan kernels against their plain versions, float32, of max(1, max
# |plain|): the JAX package's tolerance for the same kernels
SCAN_TOL = 1e-5

DEVICE = "cuda"
RING_MATMUL_TPU = "src/repro/mpc/protocols/additive2pc.py:71"
SECURE_MATMUL_TPU = "src/repro/kernels/secure_matmul.py:60"
FLASH_ATTN_TPU = "src/repro/kernels/flash_attn.py:69"
ENTROPY_HEAD_TPU = "src/repro/kernels/entropy_head.py:53"
MLP_SOFTMAX_ATTN_TPU = "src/repro/kernels/mlp_softmax_attn.py:74"
SSD_TPU = "src/repro/kernels/ssd.py:63"
RG_LRU_TPU = "src/repro/kernels/rg_lru.py:42"
CSRC = "src/repro_torch/kernels/csrc"


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


def cuda_ms(fn, *args, reps: int = 10, queued: bool = False) -> float:
    """Mean time of fn(*args) over `reps` launches (after warm-up), from
    CUDA events around the loop. Where the host issues a call more slowly
    than the card runs it, that is the host's rate; `queued` first holds
    the stream in a device-side sleep (~0.1 s) while the host queues
    every launch, so that the events read the device's time alone."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
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
    build.build()
    log(f"[1] built {sorted(build.SOURCES)} in {time.time() - t0:.1f} s")
    for name in sorted(build.SOURCES):
        for line in build.ptxas_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[1] ptxas {name}: {line.strip()}")
    for name in build.SOURCES:
        build.lib(name)
    return smi


def phase_sass(name: str, entries: dict, no_spill, require: str = None,
               forbid: tuple = None, exempt: tuple = ()) -> dict:
    """Kernel `name`'s instantiations, from its build: registers and
    spills (-Xptxas -v), fatal for one in `no_spill` that spills; and the
    witness of how it computes, from its SASS (cuobjdump): every
    instantiation but those labelled in `exempt` holds opcode `require`
    (HGMMA, the tensor cores' bf16/tf32 warpgroup product; IGMMA, their
    u8 one), none holds an
    opcode of `forbid` = (label, pattern), and the library holds no other
    kernel of `name` (no kernel left beside them). `entries` maps each
    instantiation's label to its mangled name's template part. ptxas's
    notes that it serialized wgmma are printed."""
    from repro_torch.kernels import build
    sass = build.sass(name)
    log_text = build.ptxas_log(name)
    ptxas = build.ptxas_entries(log_text)
    counts = {}
    if require:
        counts[require] = build.sass_counts(sass, require)
    if forbid:
        counts[forbid[0]] = build.sass_counts(sass, forbid[1])
    fns_all = next(iter(counts.values())) if counts else ptxas
    out = {}
    for label, tag in entries.items():
        fns = [f for f in fns_all if tag in f]
        if len(fns) != 1:
            fail(f"{name} {label}: {len(fns)} SASS entries")
        p = ptxas.get(fns[0], {})
        spill = p.get("spill_stores", -1) + p.get("spill_loads", -1)
        out[label] = {key: c.get(fns[0], 0) for key, c in counts.items()}
        out[label].update(registers=p.get("registers"), spill_bytes=spill)
        log(f"[1] {name} {label}: "
            + "".join(f"{n} {key}, " for key, n in out[label].items()
                      if key in counts)
            + f"{p.get('registers')} registers, {spill} bytes spilled")
        if require and label not in exempt and out[label][require] == 0:
            fail(f"{name} {label}: no {require} in its SASS")
        if forbid and out[label][forbid[0]]:
            fail(f"{name} {label}: {out[label][forbid[0]]} {forbid[0]} in "
                 f"its SASS")
        if spill != 0 and label in no_spill:
            fail(f"{name} {label} spills {spill} bytes")
    others = [f for f in fns_all if name in f
              and not any(tag in f for tag in entries.values())]
    if others:
        fail(f"{name}: unexpected kernel entries {others}")
    for line in log_text.splitlines():
        if "serialized" in line:
            log(f"[1] ptxas {name}: {line.strip()}")
    return out


# each kernel's instantiations (label -> its mangled name's template part)
# and those that must not spill. flash_attn: bf16 and float32 at every Dh,
# the path's two (bf16 Dh 256, float32 Dh 64) not spilling
FA_ENTRIES = {f"{t} Dh {dh}": f"flash_attn_kernelI{m}Li{dh}E"
              for t, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
              for dh in (16, 32, 64, 128, 256)}
FA_NO_SPILL = ("bf16 Dh 256", "f32 Dh 64")
# ring_matmul: every one serves the path (BN 16 where N <= 16)
RMM_ENTRIES = {"int32 BN 64": "ring_matmul_kernelIiLi64E",
               "int32 BN 16": "ring_matmul_kernelIiLi16E",
               "int64 BN 32": "ring_matmul_kernelIlLi32E",
               "int64 BN 16": "ring_matmul_kernelIlLi16E"}
# secure_matmul: every one serves the path (BN 16 where N <= 16)
SMM_ENTRIES = {"int32 BN 64": "secure_matmul_kernelIiLi64E",
               "int32 BN 16": "secure_matmul_kernelIiLi16E",
               "int64 BN 32": "secure_matmul_kernelIlLi32E",
               "int64 BN 16": "secure_matmul_kernelIlLi16E"}
# ssd: bf16 (the path's) and float32
SSD_ENTRIES = {"bf16": "ssd_kernelI13__nv_bfloat16E", "f32": "ssd_kernelIfE"}
SSD_NO_SPILL = ("bf16",)
# mlp_softmax_attn: bf16 and float32 at every Dh, the path's (float32 Dh
# 64) not spilling
MSA_ENTRIES = {f"{t} Dh {dh}": f"mlp_softmax_attn_kernelI{m}Li{dh}E"
               for t, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
               for dh in (16, 32, 64, 128)}
MSA_NO_SPILL = ("f32 Dh 64",)
# the witness that a kernel sums in a fixed order: no atomics in its SASS
# (mlp_softmax_attn's A across the cluster, rg_lru's carries)
NO_ATOMICS = ("atomics", "(?:ATOM|ATOMS|ATOMG|RED)")


# entropy_head: one thread a row and a row split across a block or a
# cluster, each in float32, bf16 and f16; the path's (float32) not
# spilling
EH_ENTRIES = {f"{k} {t}": f"entropy_head_{k}_kernelI{m}E"
              for k in ("rows", "split")
              for t, m in (("f32", "f"), ("bf16", "13__nv_bfloat16"),
                           ("f16", "6__half"))}
EH_NO_SPILL = ("rows f32", "split f32")


# the backward kernels: flash_attn's two passes (on the tensor cores:
# HGMMA in every instantiation) and mlp_softmax_attn's head pass (CUDA
# cores), bf16 and float32 at every Dh, each with one 4 x 4 tile of dA
# and dU^T a thread (x1) and, at Dh 64 and 128, with the most that hid 64
# needs (x2, x4), and its head sum (float32 partials, one instantiation);
# the training path's (float32 Dh 64, the sum) not spilling; none holding
# an atomic (every sum in a fixed order)
FA_BWD_ENTRIES = {f"{k} {t} Dh {dh}": f"fa_bwd_{k}_kernelI{m}Li{dh}E"
                  for k in ("dq", "dkdv")
                  for t, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
                  for dh in (16, 32, 64, 128)}
FA_BWD_NO_SPILL = ("dq f32 Dh 64", "dkdv f32 Dh 64")
MSA_BWD_ENTRIES = {f"heads {t} Dh {dh} x{mt}":
                   f"msa_bwd_heads_kernelI{m}Li{dh}ELi{mt}E"
                   for t, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
                   for dh in (16, 32, 64, 128)
                   for mt in sorted({1, max(1, dh // 32)})}
MSA_BWD_ENTRIES["sum"] = "msa_bwd_sum_kernel"
MSA_BWD_NO_SPILL = ("heads f32 Dh 64 x1", "heads f32 Dh 64 x2", "sum")
# the training path's backward kernels, none holding an atomic, none
# spilling: flash_attn's at Dh 256 (HGMMA required in its dq pass and its
# dk and dv passes, bf16 and float32) with its group sum and float32's
# combine of the dq parts (elementwise: exempt); ssd's (HGMMA required in
# its state and chunk passes, bf16 and float32) with its sum over the head
# groups (exempt); rg_lru's reverse recurrence
FA_BWD256_ENTRIES = {
    "dq bf16 Dh 256": "fa_bwd_dq_kernelI13__nv_bfloat16Li256E",
    "dk/dv bf16 Dh 256": "fa_bwd_kv256_kernelI13__nv_bfloat16E",
    "sum bf16 Dh 256": "fa_bwd256_sum_kernelI13__nv_bfloat16E",
    "dq f32 Dh 256": "fa_bwd_dq_kernelIfLi256E",
    "dq parts f32 Dh 256": "fa_bwd256_dq_sum_kernel",
    "dk/dv f32 Dh 256": "fa_bwd_kv256_kernelIfE",
    "sum f32 Dh 256": "fa_bwd256_sum_kernelIfE"}
FA_BWD256_NO_SPILL = tuple(FA_BWD256_ENTRIES)
FA_BWD256_CUDA_CORES = ("sum bf16 Dh 256", "dq parts f32 Dh 256",
                        "sum f32 Dh 256")
SSD_BWD_ENTRIES = {"state bf16": "ssd_bwd_state_kernelI13__nv_bfloat16E",
                   "chunk bf16": "ssd_bwd_chunk_kernelI13__nv_bfloat16E",
                   "sum bf16": "ssd_bwd_sum_kernelI13__nv_bfloat16E",
                   "state f32": "ssd_bwd_state_kernelIfE",
                   "chunk f32": "ssd_bwd_chunk_kernelIfE",
                   "sum f32": "ssd_bwd_sum_kernelIfE"}
SSD_BWD_NO_SPILL = tuple(SSD_BWD_ENTRIES)
SSD_BWD_CUDA_CORES = ("sum bf16", "sum f32")
LRU_BWD_ENTRIES = {"f32": "rg_lru_bwd_kernelE"}
SSD_BWD_REPLACES = ("none: the JAX package has no backward kernel; its "
                    "training differentiates the chunked scan "
                    "(src/repro/models/ssd.py:48)")
RG_LRU_BWD_REPLACES = ("none: the JAX package has no backward kernel; its "
                       "training differentiates the associative scan "
                       "(src/repro/models/rglru.py:73)")
FLASH_ATTN_BWD_REPLACES = ("none: the JAX package has no backward kernel; "
                           "its training differentiates plain attention "
                           "(src/repro/core/target.py:68)")
MLP_SOFTMAX_ATTN_BWD_REPLACES = ("none: the JAX package has no backward "
                                 "kernel; its in-vivo training "
                                 "differentiates the materialized MLP_sm "
                                 "attention (src/repro/core/proxy.py:"
                                 "148)")


def lru_entries() -> dict:
    """rg_lru's one instantiation, float32 at the wrapper's WARPS x
    STEPS tile; it must not spill."""
    from repro_torch.kernels import rg_lru
    return {"f32": f"rg_lru_kernelILi{rg_lru.WARPS}ELi{rg_lru.STEPS}EE"}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# ring_matmul's main-path cases, each timed on both rings
RMM_PATH = ("scores eb", "probs@v", "proj", "mlp_sm w1")


def _rmm_cases(dt):
    """(label, a shape, b shape, fill): fill "rand" (uniform over the
    ring), "bcast" (a weight broadcast over the batch by stride 0), "-1"
    (every limb 0xFF) or "extremes" (INT_MIN, INT_MAX, -1, 0, 1)."""
    from repro_torch.kernels.ring_matmul import K_CHUNK
    L = 4                                   # wave lanes
    kc = K_CHUNK[dt]
    return [
        ("scores eb", (2 * L * 48, 512, 64), (2 * L * 48, 64, 512), "rand"),
        ("probs@v", (L * 48, 512, 512), (L * 48, 512, 64), "rand"),
        ("proj", (L, 2048, 768), (L, 768, 768), "rand"),
        ("mlp_sm w1", (L, 24576, 512), (L, 512, 16), "rand"),
        ("mlp_ln w1 (K=1)", (L, 2048, 1), (L, 1, 16), "rand"),
        ("mlp_ln w2 (N=1)", (L, 2048, 16), (L, 16, 1), "rand"),
        ("ragged", (3, 67, 45), (3, 45, 131), "rand"),
        ("broadcast weight", (5, 130, 70), (5, 70, 33), "bcast"),
        ("all -1", (2, 130, 96), (2, 96, 70), "-1"),
        ("all -1, K = K_CHUNK", (2, 67, kc), (2, kc, 33), "-1"),
        ("K > K_CHUNK", (2, 67, kc + 70), (2, kc + 70, 34), "rand"),
        ("extremes", (2, 128, 128), (2, 128, 64), "extremes"),
    ]


def _ring_operands(gen, sa, sb, fill, dt, dev):
    import torch
    if fill == "-1":
        return (torch.full(sa, -1, dtype=dt, device=dev),
                torch.full(sb, -1, dtype=dt, device=dev))
    if fill == "extremes":
        info = torch.iinfo(dt)
        pick = torch.tensor([info.min, info.max, -1, 0, 1], dtype=dt,
                            device=dev)
        return tuple(pick[torch.randint(0, 5, s, generator=gen, device=dev)]
                     for s in (sa, sb))
    a = rand_ring(gen, sa, dt, dev)
    if fill == "bcast":
        return a, rand_ring(gen, (1,) + sb[1:], dt, dev).expand(sb)
    return a, rand_ring(gen, sb, dt, dev)


def _smm_cases(dt):
    """(label, batch, M, K, N, fill): fill "rand" (uniform over the
    ring), "bcast" (dlt and b broadcast over the batch by stride 0), "-1"
    (every limb 0xFF) or "unaligned" (every operand one element past a
    16-byte boundary)."""
    import torch
    from repro_torch.kernels.secure_matmul import K_CHUNK
    L = 4                                   # wave lanes
    kc = K_CHUNK[dt]
    past = {torch.int32: 4160, torch.int64: 2100}[dt]   # two folds
    return [
        ("proj combine", L, 2048, 768, 768, "rand"),
        ("mlp_sm w1 combine", L, 24576, 512, 16, "rand"),
        ("mlp_sm w2 combine", L, 24576, 16, 512, "rand"),
        ("mlp_ln combine (K=1)", L, 2048, 1, 16, "rand"),
        ("ragged", 3, 67, 45, 131, "rand"),
        ("broadcast weight", 5, 130, 70, 33, "bcast"),
        ("all -1, K = K_CHUNK", 2, 67, kc, 33, "-1"),
        ("K > K_CHUNK", 2, 67, past, 34, "rand"),
        ("unaligned rows", 3, 70, 64, 40, "unaligned"),
    ]


def _smm_operands(gen, bt, m, k, n, fill, dt, dev):
    import torch
    shapes = ((bt, m, k), (bt, k, n), (2, bt, m, k), (2, bt, k, n),
              (2, bt, m, n))
    if fill == "-1":
        return tuple(torch.full(s, -1, dtype=dt, device=dev) for s in shapes)
    eps, dlt, a_sh, b_sh, c_sh = (rand_ring(gen, s, dt, dev) for s in shapes)
    if fill == "bcast":
        dlt = dlt[:1].expand_as(dlt)
        b_sh = b_sh[:, :1].expand_as(b_sh)
    if fill == "unaligned":
        return tuple(torch.cat([t.new_zeros(1), t.flatten()])[1:].view_as(t)
                     for t in (eps, dlt, a_sh, b_sh, c_sh))
    return eps, dlt, a_sh, b_sh, c_sh


def unfused_combine(eps, dlt, a_sh, b_sh, c_sh):
    """The combine as RING64 runs it (mpc/protocols/additive2pc.py:
    `matmul` past the fused branch): three ring_matmul launches and the
    adds, party 0's eps @ dlt added last."""
    import torch
    from repro_torch.kernels import ops as kops
    eb = kops.ring_matmul(eps.expand((2,) + tuple(eps.shape)), b_sh)
    ad = kops.ring_matmul(a_sh, dlt.expand((2,) + tuple(dlt.shape)))
    z = c_sh + eb + ad
    ed = kops.ring_matmul(eps, dlt)
    return torch.cat([(z[0] + ed).unsqueeze(0), z[1:]])


def _bound_ms(nbytes: float, ops: float,
              peak_ops: float = PEAK_OPS_S) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
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
    out = {"library_error": lib_msg, "ring_matmul": {}, "secure_matmul": {},
           "ring_matmul_cases": {}}
    n0 = {"ring_matmul": rmm.stats()["kernel"],
          "secure_matmul": smm.stats()["kernel"]}
    for dt in (torch.int32, torch.int64):
        tag = str(dt).replace("torch.", "")
        cases = {}
        for label, sa, sb, fill in _rmm_cases(dt):
            a, b = _ring_operands(gen, sa, sb, fill, dt, dev)
            got = rmm.launch(a, b)
            want = ref.matmul_by_chunks(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"ring_matmul {tag} {label}: kernel != plain "
                     f"(max err {_max_err(got, want)})")
            log(f"[2] ring_matmul {tag} {label} {sa}@{sb}: bitwise equal")
            if label not in RMM_PATH:
                continue
            # the u8 limb products at the int8 tensor cores' rate, against
            # A + B + C at the element size; the CUDA cores' bound beside
            limb_ops, ring_ops, nbytes = rmm.work(*sa, sb[-1], dt)
            t = {"shape": f"{sa}@{sb}",
                 "ms": cuda_ms(rmm.launch, a, b, reps=20),
                 "device_ms": cuda_ms(rmm.launch, a, b, reps=20,
                                      queued=True),
                 "plain_ms": cuda_ms(ref.matmul_by_chunks, a, b, reps=2),
                 "max_abs_err": 0.0}
            t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, limb_ops,
                                                     PEAK_INT8_S)
            t["cuda_core_bound_ms"] = _bound_ms(nbytes, ring_ops)[0]
            t["bound_share"] = t["bound_ms"] / t["ms"]
            cases[label] = t
            log(f"[2] ring_matmul {tag} {label}: {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                f"{100 * t['bound_share']:.1f} % of it; CUDA-core bound "
                f"{t['cuda_core_bound_ms']:.4f} ms)")
            del a, b, got, want
        out["ring_matmul"][tag] = cases["scores eb"]
        out["ring_matmul_cases"][tag] = cases
        for label, bt, m, k, n, fill in _smm_cases(dt):
            args = _smm_operands(gen, bt, m, k, n, fill, dt, dev)
            got = smm.launch(*args)
            want = smm.secure_matmul_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"secure_matmul {tag} {label}: kernel != plain "
                     f"(max err {_max_err(got, want)})")
            log(f"[2] secure_matmul {tag} {label} b{bt} {m}x{k}x{n}: "
                f"bitwise equal")
            if label == "proj combine":
                if not torch.equal(unfused_combine(*args), want):
                    fail(f"secure_matmul {tag}: the unfused route != plain")
                limb_ops, ring_ops, nbytes = smm.work(bt, m, k, n, dt)
                t = {"shape": f"b{bt} {m}x{k}x{n}",
                     "ms": cuda_ms(smm.launch, *args, reps=20),
                     "device_ms": cuda_ms(smm.launch, *args, reps=20,
                                          queued=True),
                     "plain_ms": cuda_ms(smm.secure_matmul_plain, *args,
                                         reps=2),
                     "unfused_ms": cuda_ms(unfused_combine, *args, reps=20),
                     "unfused_device_ms": cuda_ms(unfused_combine, *args,
                                                  reps=20, queued=True),
                     "max_abs_err": 0.0}
                t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, limb_ops,
                                                         PEAK_INT8_S)
                t["cuda_core_bound_ms"] = _bound_ms(nbytes, ring_ops)[0]
                t["bound_share"] = t["bound_ms"] / t["ms"]
                out["secure_matmul"][tag] = t
                log(f"[2] secure_matmul {tag} {label}: {t['ms']:.4f} ms "
                    f"(device {t['device_ms']:.4f}), plain "
                    f"{t['plain_ms']:.4f} ms, unfused route "
                    f"{t['unfused_ms']:.4f} ms (device "
                    f"{t['unfused_device_ms']:.4f}), bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                    f"{100 * t['bound_share']:.1f} % of it; CUDA-core bound "
                    f"{t['cuda_core_bound_ms']:.4f} ms)")
            del args, got, want
    out["check_launches"] = {
        "ring_matmul": rmm.stats()["kernel"] - n0["ring_matmul"],
        "secure_matmul": smm.stats()["kernel"] - n0["secure_matmul"]}
    log(f"[2] launches in this phase (not the main path's): "
        f"{out['check_launches']}")
    return out


def _rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|))."""
    err = _max_err(got, want)
    return err, err / max(1.0, float(want.double().abs().max()))


def phase_float_kernels(seed: int) -> dict:
    """The float kernels against their plain versions: (label, inputs,
    timed?) cases at the clear paths' shapes, float32 within TOL of
    max |plain|, bfloat16 within BF16_TOL (one bf16 rounding of the
    output). The timed case is the one the main path (phase 6) runs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import entropy_head as eh
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import mlp_softmax_attn as msa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)

    def randn(shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    def check(name, label, got, want, tol, res):
        torch.cuda.synchronize()
        err, rel = _rel_err(got, want)
        if not rel <= tol:
            fail(f"{name} {label}: kernel vs plain error {err:.3g} "
                 f"({rel:.3g} of max |plain|, limit {tol})")
        key = "max_abs_err" if got.dtype != bf16 else "bf16_max_abs_err"
        res[key] = max(res.get(key, 0.0), err)
        log(f"[2] {name} {label}: max err {err:.3g} ({rel:.3g} of max "
            f"|plain|, limit {tol})")

    out = {}
    # flash_attn: (label, BH, Sq, Skv, Dh, group, dtype, causal, window,
    # input scale, timed); BH 192 is the Oracle's batch of 16 x 12 heads
    # at BERT width, float32 (phase 6a); (40, 512, 256), group 10, causal
    # is a RecurrentGemma prefill batch (4 x 10 heads over one kv head) in
    # bfloat16, phase 7's dtype and shape, where the local window of 2048
    # covers the prompt; its float32 twin is checked, not timed. The
    # windowed cases are prompts longer than their window; scale 3 gives
    # scores of ~30, where one tf32 pass would miss the float32 limit
    # Then the prefix mask and cross-attention (phase 7b): PaliGemma's
    # prefill batch (32, 768, 256), group 8 (4 rows x 8 heads over one kv
    # head), prefix 256 (its image tokens), bf16, timed, with the ragged
    # and small prefixes (0, 1, = S, past a key tile at an S that is not a
    # tile multiple); Whisper's cross-attention, 48 x 64 queries (4 rows x
    # 12 heads) over 1,500 encoder keys, bidir, bf16, timed, and float32.
    # The last element of a case, where present, is its prefix.
    res = out["flash_attn"] = {}
    for (label, bh, sq, skv, dh, group, dt, causal, window, scale, timed,
         *prefix) in (
            ("path (Oracle batch)", 192, 512, 512, 64, 1, f32, False, 0, 1,
             True),
            ("48 heads", 48, 512, 512, 64, 1, f32, False, 0, 1, False),
            ("causal", 48, 512, 512, 64, 1, f32, True, 0, 1, False),
            ("ragged", 48, 100, 100, 64, 1, f32, False, 0, 1, False),
            ("ragged causal", 48, 100, 100, 64, 1, f32, True, 0, 1, False),
            ("bf16", 48, 512, 512, 64, 1, bf16, False, 0, 1, False),
            ("large scores", 48, 512, 512, 64, 1, f32, False, 0, 3, False),
            ("Sq 1, ragged Skv", 48, 1, 100, 64, 1, f32, False, 0, 1,
             False),
            ("path (RecurrentGemma prefill)", 40, 512, 512, 256, 10, bf16,
             True, 2048, 1, True),
            ("Dh 256 f32", 40, 512, 512, 256, 10, f32, True, 2048, 1,
             False),
            ("Dh 256 large scores", 40, 512, 512, 256, 10, f32, True, 2048,
             3, False),
            ("Dh 256 bf16 large scores", 40, 512, 512, 256, 10, bf16, True,
             2048, 3, False),
            ("Dh 256 ragged", 20, 130, 130, 256, 10, f32, True, 0, 1,
             False),
            ("Dh 256 window 256", 40, 1024, 1024, 256, 10, f32, True, 256,
             1, False),
            ("Dh 256 window 16", 20, 300, 300, 256, 10, f32, True, 16, 1,
             False),
            ("ragged window 100", 20, 300, 300, 256, 10, bf16, True, 100, 1,
             False),
            ("window 50", 48, 512, 512, 64, 1, f32, True, 50, 1, False),
            ("path (PaliGemma prefill)", 32, 768, 768, 256, 8, bf16, True,
             0, 1, True, 256),
            ("prefix f32", 32, 768, 768, 256, 8, f32, True, 0, 1, False,
             256),
            ("prefix 0", 8, 300, 300, 256, 8, bf16, True, 0, 1, False, 0),
            ("prefix 1", 8, 300, 300, 256, 8, bf16, True, 0, 1, False, 1),
            ("prefix = S", 8, 300, 300, 256, 8, f32, True, 0, 1, False,
             300),
            ("prefix past a tile", 8, 300, 300, 256, 8, f32, True, 0, 1,
             False, 70),
            ("prefix ragged Dh 64", 12, 130, 130, 64, 1, f32, True, 0, 1,
             False, 65),
            ("path (Whisper cross-attention)", 48, 64, 1500, 64, 1, bf16,
             False, 0, 1, True),
            ("cross f32", 48, 64, 1500, 64, 1, f32, False, 0, 1, False)):
        prefix = prefix[0] if prefix else 0
        q = randn((bh, sq, dh), dt, scale)
        k = randn((bh // group, skv, dh), dt, scale)
        v = randn((bh // group, skv, dh), dt)
        tag = str(dt).replace("torch.", "")
        check("flash_attn", f"{label} ({bh},{sq},{dh}) Skv {skv} group "
              f"{group} {tag}{f' window {window}' if window else ''}"
              f"{f' prefix {prefix}' if prefix else ''}",
              fa.launch(q, k, v, causal, window, prefix),
              ref.flash_attn(q, k, v, causal=causal, window=window,
                             prefix_len=prefix),
              TOL if dt == f32 else BF16_TOL, res)
        if not timed:
            continue
        t = {"ms": cuda_ms(fa.launch, q, k, v, causal, window, prefix,
                           reps=50),
             "plain_ms": cuda_ms(lambda *a: ref.flash_attn(
                 *a, causal=causal, window=window, prefix_len=prefix),
                 q, k, v)}
        # SDPA on the same (B, heads, S, Dh) problem in the same dtype, kv
        # heads shared (the timed windows cover S, so its causal mask is
        # the same function; the prefix and cross cases pass the mask as
        # an explicit boolean attn_mask); each also timed queued, the
        # device alone
        qs, ks, vs = (x.reshape(-1, g, x.shape[1], dh)
                      for x, g in ((q, group), (k, 1), (v, 1)))
        mask = None
        if label.startswith(("path (PaliGemma", "path (Whisper")):
            mask = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
            if causal:
                mask = mask.tril()
                mask[:, :prefix] = True

        def sdpa(*a):
            return F.scaled_dot_product_attention(
                *a, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=group > 1)
        t["library_ms"] = cuda_ms(sdpa, qs, ks, vs, reps=50)
        t["device_ms"] = cuda_ms(fa.launch, q, k, v, causal, window, prefix,
                                 reps=50, queued=True)
        t["library_device_ms"] = cuda_ms(sdpa, qs, ks, vs, reps=50,
                                         queued=True)
        lib_err = _max_err(sdpa(qs, ks, vs).reshape(bh, sq, dh),
            ref.flash_attn(q, k, v, causal=causal, window=window,
                           prefix_len=prefix))
        ops, nbytes = fa.work(q.shape, k.shape[0], dt, causal, window, skv,
                              prefix)
        # one bound per dtype: bf16 products at the tensor cores' bf16
        # rate; float32 at 3xTF32's (three tf32 products for each), with
        # the CUDA cores' float32 bound beside it
        t["bound_ms"], t["bound_by"] = _bound_ms(
            nbytes, ops, PEAK_BF16_S if dt == bf16 else PEAK_3XTF32_S)
        if dt == f32:
            t["cuda_core_bound_ms"] = _bound_ms(nbytes, ops)[0]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["shape"] = (f"({bh},{sq},{dh}) Skv {skv} group {group} {tag} "
                      f"{'causal' if causal else 'non-causal'}"
                      f"{f' prefix {prefix}' if prefix else ''}")
        if label.startswith("path (PaliGemma"):
            res["prefix"] = t
        elif label.startswith("path (Whisper"):
            res["cross"] = t
        elif dh == 256:
            res["dh256"] = t
        else:
            res.update(t)
        log(f"[2] flash_attn {t['shape']}: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}; max err vs plain {lib_err:.3g}), "
            f"bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_share']:.1f} % of it"
            + (f"; CUDA-core bound {t['cuda_core_bound_ms']:.4f} ms)"
               if dt == f32 else ")"))

    # entropy_head: (label, R, V, dtype, fill); (16, 2) is the Oracle's
    # batch of 16 over 2 classes, (256, 30522) a vocabulary-wide head, the
    # two timed; then the split kernel's hard cases: V of 1 and 3 (no whole
    # 16-byte vector), a ragged tail (V 30521, an odd row stride), one
    # row, few rows (a cluster of 4 and of 8 blocks a row), many narrow
    # rows, logits of scale 1e4 (one-hot rows, where m and s / z cancel),
    # all-equal rows, a transposed-then-sliced view, and bf16 and f16 rows
    # at a stride off 16 bytes
    res = out["entropy_head"] = {}
    f16 = torch.float16

    def categorical(x):
        """The one PyTorch call a user would write for this function: a
        yardstick, never on the path."""
        return torch.distributions.Categorical(
            logits=x, validate_args=False).entropy()

    def eh_logits(r, v, dt, fill):
        if fill == "equal":
            return randn((r, 1), dt, 3.0).expand(r, v).contiguous()
        if fill == "strided":
            return randn((v + 8, r), dt, 3.0).t()[:, 3:3 + v]
        return randn((r, v), dt, 1e4 if fill == "scale 1e4" else 3.0)

    for label, r, v, dt, fill in (
            ("path (Oracle batch)", 16, 2, f32, "randn"),
            ("64 x 2", 64, 2, f32, "randn"),
            ("vocab", 256, 30522, f32, "randn"),
            ("ragged", 7, 1000, f32, "randn"),
            ("vocab bf16", 256, 30522, bf16, "randn"),
            ("V 1", 5, 1, f32, "randn"),
            ("V 3", 5, 3, f32, "randn"),
            ("V 30521", 256, 30521, f32, "randn"),
            ("R 1", 1, 30522, f32, "randn"),
            ("few rows (cluster of 4)", 16, 30522, f32, "randn"),
            ("serving head (cluster of 8)", 4, 256000, f32, "randn"),
            ("many narrow rows", 65536, 2, f32, "randn"),
            ("scale 1e4", 64, 30522, f32, "scale 1e4"),
            ("all equal", 16, 30522, f32, "equal"),
            ("transposed then sliced", 64, 30522, f32, "strided"),
            ("bf16 odd stride", 256, 30521, bf16, "randn"),
            ("f16 odd stride", 256, 30521, f16, "randn"),
            ("f16 few rows", 16, 30521, f16, "randn")):
        x = eh_logits(r, v, dt, fill)
        tag = str(dt).replace("torch.", "")
        got = eh.launch(x)
        check("entropy_head", f"{label} ({r},{v}) {tag} plan "
              f"{eh.plan(r, v)}", got, ref.entropy_head(x), EH_TOL, res)
        if label in ("path (Oracle batch)", "vocab", "few rows (cluster of "
                     "4)", "serving head (cluster of 8)", "many narrow rows",
                     "bf16 odd stride"):
            again = eh.launch(x)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"entropy_head {label}: two launches differ by "
                     f"{_max_err(got, again)}")
            res.setdefault("bitwise_repeat", []).append(label)
            log(f"[2] entropy_head {label}: two launches bitwise equal")
        if label not in ("path (Oracle batch)", "vocab"):
            continue
        # timed host-issued and queued (the device alone), and queued over
        # four copies of the logits in turn (four vocab copies, 125 MB,
        # outrun the 50 MB L2); the plain version and the yardstick beside
        copies = itertools.cycle([x] + [eh_logits(r, v, dt, fill)
                                        for _ in range(3)])
        t = {"ms": cuda_ms(eh.launch, x, reps=50),
             "device_ms": cuda_ms(eh.launch, x, reps=50, queued=True),
             "rotating_device_ms": cuda_ms(
                 lambda: eh.launch(next(copies)), reps=50, queued=True),
             "plain_ms": cuda_ms(ref.entropy_head, x),
             "plain_device_ms": cuda_ms(ref.entropy_head, x, queued=True),
             "library_ms": cuda_ms(categorical, x),
             "library_device_ms": cuda_ms(categorical, x, queued=True)}
        lib_err = _max_err(categorical(x), ref.entropy_head(x))
        ops, nbytes = eh.work(r, v, dt)
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, ops)
        for key in ("ms", "device_ms", "rotating_device_ms"):
            t[key.replace("ms", "bound_share")] = t["bound_ms"] / t[key]
        t["shape"] = f"({r},{v}) {tag}"
        t["plan"] = eh.plan(r, v)
        del copies
        if label == "vocab":
            res["vocab"] = t
        else:
            res.update(t)
        log(f"[2] entropy_head {t['shape']} plan {t['plan']}: "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, over four "
            f"copies {t['rotating_device_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f}), "
            f"Categorical {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}; max err vs plain "
            f"{lib_err:.3g}), bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
            f"{100 * t['rotating_device_bound_share']:.1f} % of it over "
            f"four copies)")

    # mlp_softmax_attn: (label, BH, Sq, Skv, Dh, hid, dtype, timed); the
    # clear sieve's phase 2 (<3,12,16>, batch 4) gives BH 48, hid 16,
    # phase 1 (<1,1,2>) BH 4, hid 2; then the cluster's hard cases: Sq
    # 1024 (two query tiles a block), Sq 1 and 8 (a cluster of one), Skv
    # not a multiple of C x 64, hid 64, Dh 16 and 128 in bf16; and a dense
    # but permuted q, the head-folded q of a clear-sieve batch of one row
    res = out["mlp_softmax_attn"] = {}
    for label, bh, sq, skv, dh, hid, dt, timed in (
            ("path phase 2", 48, 512, 512, 64, 16, f32, "path"),
            ("hid 2", 48, 512, 512, 64, 2, f32, None),
            ("path phase 1", 4, 512, 512, 64, 2, f32, "phase1"),
            ("ragged", 48, 100, 100, 64, 16, f32, None),
            ("bf16", 48, 512, 512, 64, 16, bf16, None),
            ("Sq 1024", 48, 1024, 1024, 64, 16, f32, None),
            ("Sq 1", 48, 1, 512, 64, 16, f32, None),
            ("Sq 8", 48, 8, 8, 64, 16, f32, None),
            ("Skv 450", 48, 512, 450, 64, 5, f32, None),
            ("hid 64", 48, 512, 512, 64, 64, f32, None),
            ("Dh 16 bf16", 48, 512, 512, 16, 16, bf16, None),
            ("Dh 128 bf16", 48, 512, 512, 128, 16, bf16, None),
            ("q permuted", 12, 512, 512, 64, 16, f32, None)):
        q = randn((sq, bh, dh), dt).transpose(0, 1) \
            if label == "q permuted" else randn((bh, sq, dh), dt)
        k, v = (randn((bh, skv, dh), dt) for _ in range(2))
        w = (randn((skv, hid), scale=0.2), randn((hid,), scale=0.1),
             randn((hid, skv), scale=0.2), randn((skv,), scale=0.01))
        got = msa.launch(q, k, v, *w)
        check("mlp_softmax_attn", f"{label} ({bh},{sq},{dh}) Skv {skv} hid "
              f"{hid} {str(dt)[6:]}", got, ref.mlp_softmax_attn(q, k, v, *w),
              TOL if dt == f32 else BF16_TOL, res)
        if label in ("path phase 2", "Sq 1024"):
            again = msa.launch(q, k, v, *w)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"mlp_softmax_attn {label}: two launches differ by "
                     f"{_max_err(got, again)}")
            res.setdefault("bitwise_repeat", []).append(label)
            log(f"[2] mlp_softmax_attn {label}: two launches bitwise equal")
        if not timed:
            continue
        nbytes, ops = msa.work(bh, 1, sq, skv, dh, hid, dt)
        t = {"ms": cuda_ms(msa.launch, q, k, v, *w, reps=50),
             "device_ms": cuda_ms(msa.launch, q, k, v, *w, reps=50,
                                  queued=True),
             "shape": f"({bh},{sq},{dh}) hid {hid} f32"}
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, ops)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["device_bound_share"] = t["bound_ms"] / t["device_ms"]
        if timed == "phase1":
            res["phase1"] = t
        else:
            t["plain_ms"] = cuda_ms(ref.mlp_softmax_attn, q, k, v, *w)
            # the score form's operations on the CUDA cores: the bound
            # of the kernel before A = K^T W1 came first
            old_ops = 2.0 * bh * sq * skv * (dh + hid) \
                + 2.0 * bh * sq * hid * dh + 2.0 * bh * hid * skv * dh \
                + 2.0 * bh * skv * dh
            t["old_ops_bound_ms"] = old_ops / PEAK_OPS_S * 1e3
            res.update(t)
        log(f"[2] mlp_softmax_attn {t['shape']}: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), "
            + (f"plain {t['plain_ms']:.4f} ms, " if "plain_ms" in t else "")
            + f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['device_bound_share']:.1f} % of it in device time)"
            + (f"; the score form's operations bound "
               f"{t['old_ops_bound_ms']:.4f} ms" if "old_ops_bound_ms" in t
               else ""))
    return out


def phase_backward_kernels(seed: int) -> dict:
    """The two backward kernels against autograd of their plain versions
    on the card (`ref.flash_attn`, `ref.mlp_softmax_attn`), every
    gradient within TOL (float32) or BF16_TOL of max(1, max |plain|), at
    the training path's shapes and ragged, causal, windowed, grouped,
    other-Dh and bf16 ones; bitwise equal on a second launch at the path
    shapes; the path cases timed host-issued and queued beside the plain
    backward versions (`ref.flash_attn_bwd`, `ref.mlp_softmax_attn_bwd`),
    the bound of `bwd_work` and, for flash_attn, SDPA's forward and
    backward at the same shape and dtype and its forward alone, whose
    difference is SDPA's backward alone (yardsticks, not on the path);
    flash_attn's path case is also timed in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import mlp_softmax_attn as msa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)

    def randn(shape, dtype=f32, scale=1.0, grad=False):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)
        return x.requires_grad_() if grad else x

    def check(name, label, got, want, tol, res):
        torch.cuda.synchronize()
        worst = max((_rel_err(g, w) for g, w in zip(got, want)),
                    key=lambda e: e[1])
        if not worst[1] <= tol:
            fail(f"{name} {label}: kernel vs autograd of plain error "
                 f"{worst[0]:.3g} ({worst[1]:.3g} of max |plain|, limit "
                 f"{tol})")
        key = "bf16_max_abs_err" if got[0].dtype == bf16 else "max_abs_err"
        res[key] = max(res.get(key, 0.0), worst[0])
        log(f"[2] {name} {label}: max err {worst[0]:.3g} ({worst[1]:.3g} "
            f"of max |plain|, limit {tol})")

    def repeat(name, label, fn, res):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"{name} {label}: two launches differ")
        res.setdefault("bitwise_repeat", []).append(label)
        log(f"[2] {name} {label}: two launches bitwise equal")

    out = {}
    # flash_attn backward: (label, BH, S, Dh, group, dtype, causal,
    # window, timed[, input scale]); (96, 512, 64) is M_g's finetune at
    # BERT width (batch 8 x 12 heads), float32, bidirectional, also timed
    # in bf16; the hard cases after the first nine put S off the tiles
    # (the dq pass walks keys by 64, halved at Dh 128; the dk/dv pass
    # queries by 32 in float32 and 64 in bf16), every Dh in both types,
    # RecurrentGemma's group of 10, a window whose first key tile is
    # partial, and scores of ~30 (inputs x 3: one tf32 pass misses TOL)
    res = out["flash_attn_bwd"] = {}
    for (label, bh, s, dh, group, dt, causal, window, timed, *scale) in (
            ("path (M_g finetune)", 96, 512, 64, 1, f32, False, 0, True),
            ("ragged", 24, 100, 64, 1, f32, False, 0, False),
            ("causal", 24, 512, 64, 1, f32, True, 0, False),
            ("ragged causal window 50", 12, 300, 64, 1, f32, True, 50,
             False),
            ("group 3", 12, 130, 32, 3, f32, True, 0, False),
            ("Dh 128", 8, 200, 128, 1, f32, False, 0, False),
            ("Dh 16", 8, 70, 16, 1, f32, False, 0, False),
            ("bf16", 24, 512, 64, 1, bf16, False, 0, False),
            ("bf16 Dh 128 causal", 6, 67, 128, 3, bf16, True, 20, False),
            ("path bf16", 96, 512, 64, 1, bf16, False, 0, True),
            ("S 1", 8, 1, 64, 1, f32, False, 0, False),
            ("S 63 causal", 8, 63, 64, 1, f32, True, 0, False),
            ("S 65", 8, 65, 64, 1, f32, False, 0, False),
            ("S 300 causal", 8, 300, 64, 1, f32, True, 0, False),
            ("Dh 32", 8, 200, 32, 1, f32, False, 0, False),
            ("Dh 128 causal S 300", 4, 300, 128, 1, f32, True, 0, False),
            ("bf16 Dh 16", 8, 90, 16, 1, bf16, False, 0, False),
            ("bf16 Dh 32 causal", 8, 90, 32, 1, bf16, True, 0, False),
            ("bf16 Dh 128 S 300", 4, 300, 128, 1, bf16, False, 0, False),
            ("group 10", 20, 512, 64, 10, f32, True, 0, False),
            ("window 70", 12, 300, 64, 1, f32, True, 70, False),
            ("inputs x3", 24, 512, 64, 1, f32, False, 0, False, 3.0),
            ("inputs x3 causal window 70 group 2", 12, 300, 64, 2, f32,
             True, 70, False, 3.0)):
        sc = scale[0] if scale else 1.0
        q = randn((bh, s, dh), dt, scale=sc, grad=True)
        k = randn((bh // group, s, dh), dt, scale=sc, grad=True)
        v = randn((bh // group, s, dh), dt, grad=True)
        do = randn((bh, s, dh), dt)
        got = torch.autograd.grad(
            fa.flash_attn(q, k, v, causal=causal, window=window),
            (q, k, v), do)
        want = torch.autograd.grad(
            ref.flash_attn(q, k, v, causal=causal, window=window),
            (q, k, v), do)
        tag = str(dt)[6:]
        check("flash_attn backward", f"{label} ({bh},{s},{dh}) group "
              f"{group} {tag}{' causal' if causal else ''}"
              f"{f' window {window}' if window else ''}"
              f"{f' inputs x{sc:g}' if sc != 1 else ''}", got, want,
              TOL if dt == f32 else BF16_TOL, res)
        if label not in ("path (M_g finetune)", "group 3", "path bf16"):
            continue
        q, k, v = q.detach(), k.detach(), v.detach()
        o = fa.launch(q, k, v, causal, window)
        if label != "path bf16":
            repeat("flash_attn backward", label,
                   lambda: fa.launch_bwd(q, k, v, o, do, causal, window),
                   res)
        if not timed:
            continue
        # SDPA's forward and backward on the same (B, heads, S, Dh) and
        # dtype
        qs, ks, vs = (x.reshape(-1, 12, s, dh).clone().requires_grad_()
                      for x in (q, k, v))
        dos = do.reshape(-1, 12, s, dh)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(
                F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs),
                dos)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs)

        def plain():
            return ref.flash_attn_bwd(q, k, v, o, do, causal=False)
        t = {"ms": cuda_ms(fa.launch_bwd, q, k, v, o, do, False, reps=20),
             "device_ms": cuda_ms(fa.launch_bwd, q, k, v, o, do, False,
                                  reps=20, queued=True),
             "plain_ms": cuda_ms(plain, reps=5),
             "library_ms": cuda_ms(sdpa_fwd_bwd, reps=20),
             "library_device_ms": cuda_ms(sdpa_fwd_bwd, reps=20,
                                          queued=True),
             "library_fwd_device_ms": cuda_ms(sdpa_fwd, reps=20,
                                              queued=True)}
        # SDPA's backward alone: its forward and backward less its forward
        t["library_bwd_device_ms"] = (t["library_device_ms"]
                                      - t["library_fwd_device_ms"])
        # the tensor cores' rate for the type, as the forward's bound;
        # the CUDA cores' 67 T/s beside it
        ops, nbytes = fa.bwd_work(q.shape, k.shape[0], dt, causal, window)
        t["bound_ms"], t["bound_by"] = _bound_ms(
            nbytes, ops, PEAK_BF16_S if dt == bf16 else PEAK_3XTF32_S)
        t["cuda_core_bound_ms"] = _bound_ms(nbytes, ops)[0]
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        t["shape"] = f"({bh},{s},{dh}) {tag} bidirectional"
        if dt == bf16:
            res["bf16"] = t
        else:
            res.update(t)
        log(f"[2] flash_attn backward {t['shape']}: {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"SDPA forward + backward {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}; forward alone "
            f"{t['library_fwd_device_ms']:.4f}, so backward alone "
            f"{t['library_bwd_device_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_share']:.1f} % of it in device time; "
            f"CUDA-core bound {t['cuda_core_bound_ms']:.4f} ms)")

    # mlp_softmax_attn backward: (label, BH, Sq, Skv, Dh, hid, group,
    # dtype, timed); in-vivo at batch 8: phase 2's <3,12,16> gives BH 96,
    # hid 16, phase 1's <1,1,2> BH 8, hid 2; after the permuted q, the
    # head pass's other walks: k and v as the strided views mlp_attend
    # passes (also repeated bitwise), two work items a block, a cluster of
    # one, a single key row, 17 kv heads (uneven head groups in the sum),
    # a group of 4 with ragged tiles, bf16 streaming its keys at Dh 128
    res = out["mlp_softmax_attn_bwd"] = {}
    for (label, bh, sq, skv, dh, hid, group, dt, timed) in (
            ("path phase 2 (in-vivo)", 96, 512, 512, 64, 16, 1, f32, "path"),
            ("path phase 1 (in-vivo)", 8, 512, 512, 64, 2, 1, f32,
             "phase1"),
            ("ragged", 12, 100, 100, 64, 5, 1, f32, None),
            ("group 3", 12, 130, 130, 32, 7, 3, f32, None),
            ("Skv 600 Dh 128", 4, 64, 600, 128, 16, 1, f32, None),
            ("hid 64 Dh 128", 4, 200, 200, 128, 64, 1, f32, None),
            ("Dh 16", 6, 70, 70, 16, 3, 1, f32, None),
            ("bf16", 24, 512, 512, 64, 16, 1, bf16, None),
            ("q permuted", 12, 512, 512, 64, 16, 1, f32, None),
            ("k, v transposed (mlp_attend)", 24, 512, 512, 64, 16, 2, f32,
             "repeat"),
            ("Sq 1024", 4, 1024, 300, 64, 16, 1, f32, None),
            ("Sq 1", 3, 1, 9, 32, 4, 1, f32, None),
            ("Skv 1", 8, 300, 1, 64, 1, 1, f32, None),
            ("17 kv heads", 17, 65, 65, 16, 2, 1, f32, None),
            ("group 4 ragged", 8, 100, 257, 32, 16, 4, f32, None),
            ("bf16 Skv 600 Dh 128 hid 64", 2, 64, 600, 128, 64, 1, bf16,
             None)):
        if label == "q permuted":
            qb = randn((sq, bh, dh), dt, grad=True)
            q = qb.transpose(0, 1)
        else:
            q = qb = randn((bh, sq, dh), dt, grad=True)
        if label.startswith("k, v transposed"):
            # as engine.clear.mlp_attend passes them: k from kT
            # transposed, v with its heads moved
            kb = randn((bh // group, dh, skv), dt, grad=True)
            vb = randn((skv, bh // group, dh), dt, grad=True)
            k, v = kb.transpose(-1, -2), vb.transpose(0, 1)
        else:
            k, v = kb, vb = tuple(randn((bh // group, skv, dh), dt,
                                        grad=True) for _ in "kv")
        w = [randn(sh, scale=sc, grad=True) for sh, sc in (
            ((skv, hid), 0.2), ((hid,), 0.1), ((hid, skv), 0.2),
            ((skv,), 0.01))]
        do = randn((bh, sq, dh), dt)
        ins = (qb, kb, vb, *w)
        got = torch.autograd.grad(msa.mlp_softmax_attn(q, k, v, *w), ins,
                                  do)
        want = torch.autograd.grad(ref.mlp_softmax_attn(q, k, v, *w), ins,
                                   do)
        check("mlp_softmax_attn backward", f"{label} ({bh},{sq},{dh}) Skv "
              f"{skv} hid {hid} group {group} {str(dt)[6:]}", got, want,
              TOL if dt == f32 else BF16_TOL, res)
        if not timed:
            continue
        args = [x.detach() for x in (q, k, v, *w)] + [do]
        if timed in ("path", "repeat"):
            repeat("mlp_softmax_attn backward", label,
                   lambda: msa.launch_bwd(*args), res)
        if timed == "repeat":
            continue
        if timed == "path":
            # a call launches the head pass and the head sum, each counted
            msa.reset_bwd_stats()
            msa.launch_bwd(*args)
            if msa.bwd_stats() != {"kernel": 2, "ref": 0}:
                fail(f"mlp_softmax_attn backward: one call counted "
                     f"{msa.bwd_stats()}, not two launches")
            msa.reset_bwd_stats()
        nbytes, ops = msa.bwd_work(bh, group, sq, skv, dh, hid, dt)
        t = {"ms": cuda_ms(msa.launch_bwd, *args, reps=20),
             "device_ms": cuda_ms(msa.launch_bwd, *args, reps=20,
                                  queued=True),
             "plain_ms": cuda_ms(ref.mlp_softmax_attn_bwd, *args, reps=5),
             "shape": f"({bh},{sq},{dh}) hid {hid} f32"}
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, ops, PEAK_3XTF32_S)
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        if timed == "phase1":
            res["phase1"] = t
        else:
            res.update(t)
        log(f"[2] mlp_softmax_attn backward {t['shape']}: {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_share']:.1f} % of it in device time)")
    return out


def phase_scan_kernels(seed: int) -> dict:
    """The scan kernels against their plain versions: ssd (y and the
    final state against the sequential oracle `ref.ssd`, the state also
    against the plain chunked scan `ref.ssd_chunked`) and rg_lru against
    `ref.rg_lru`, at phase 7's shapes plus ragged ones, within SCAN_TOL of
    max(1, max |plain|) in float32 (BF16_TOL for ssd's bfloat16 y), with
    ssd's hard cases in both dtypes. The timed cases are the path's: one
    Mamba-2 prefill batch (x (4, 512, 80, 64) bfloat16; its float32 twin
    beside it) and one RecurrentGemma recurrence (4, 512, 2560)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as lru_k
    from repro_torch.kernels import ssd as ssd_k
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 200)

    def randn(shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    def check(name, label, got, want, tol, res):
        torch.cuda.synchronize()
        err, rel = _rel_err(got, want)
        if not rel <= tol:
            fail(f"{name} {label}: kernel vs plain error {err:.3g} "
                 f"({rel:.3g} of max(1, max |plain|), limit {tol})")
        key = "max_abs_err" if got.dtype != bf16 else "bf16_max_abs_err"
        res[key] = max(res.get(key, 0.0), err)
        log(f"[2] {name} {label}: max err {err:.3g} ({rel:.3g} of "
            f"max(1, max |plain|), limit {tol})")

    out = {}
    # ssd: (label, B, T, H, P, N, dtype, initial state scale, timed), at
    # chunk 128 with log decays -|0.5 N(0, 1)|; then the hard cases, each
    # in both dtypes: (label, B, T, H, P, N, chunk, log decays, initial
    # state scale)
    q = ssd_k.MAX_CHUNK
    cases = [(label, bsz, t, h, p, n, dt, q, "rand", s0_scale, timed)
             for label, bsz, t, h, p, n, dt, s0_scale, timed in (
        ("path (Mamba-2 prefill batch)", 4, 512, 80, 64, 128, bf16, None,
         True),
        ("path f32", 4, 512, 80, 64, 128, f32, None, True),
        ("ragged T (300)", 2, 300, 5, 64, 128, f32, None, False),
        ("one chunk (T 100)", 3, 100, 4, 64, 128, f32, None, False),
        ("B*H 8 < 132, initial state", 1, 512, 8, 64, 128, f32, 0.5,
         False),
        ("smoke widths", 2, 64, 8, 16, 16, f32, None, False))]
    cases += [(label, bsz, t, h, p, n, dt, chunk, a_kind, s0_scale, False)
              for dt in (bf16, f32)
              for label, bsz, t, h, p, n, chunk, a_kind, s0_scale in (
        ("a = 0", 1, 512, 8, 64, 128, q, "zero", 0.5),
        ("a very negative", 1, 256, 8, 64, 128, q, "very negative", 0.5),
        ("large initial state", 1, 256, 8, 64, 128, q, "rand", 100.0),
        ("chunk 1", 1, 64, 8, 64, 128, 1, "rand", 0.5),
        ("chunk 48, P 40, N 96", 2, 100, 3, 40, 96, 48, "rand", 0.5),
        ("P 1", 2, 130, 4, 1, 128, q, "rand", 0.5),
        ("N 1", 2, 130, 4, 64, 1, q, "rand", 0.5),
        ("T 1", 3, 1, 8, 64, 128, q, "rand", 0.5))]
    res = out["ssd"] = {}
    for label, bsz, t, h, p, n, dt, chunk, a_kind, s0_scale, timed in cases:
        x = randn((bsz, t, h, p), dt)
        a = {"rand": lambda: -randn((bsz, t, h), scale=0.5).abs(),
             "zero": lambda: torch.zeros((bsz, t, h), device="cuda"),
             "very negative": lambda: -50.0 - randn((bsz, t, h)).abs()
             }[a_kind]()
        b, c = (randn((bsz, t, n), dt, 0.3) for _ in range(2))
        s0 = None if s0_scale is None else \
            randn((bsz, h, p, n), scale=s0_scale)
        y, state = ssd_k.launch(x, a, b, c, chunk, s0)
        want_y, want_s = ref.ssd(x, a, b, c, s0)
        tag = (f"{label} x ({bsz},{t},{h},{p}) N {n} chunk {chunk} "
               f"{str(dt)[6:]}")
        check("ssd", f"{tag} y", y, want_y,
              SCAN_TOL if dt == f32 else BF16_TOL, res)
        check("ssd", f"{tag} final state", state, want_s, SCAN_TOL, res)
        if t % chunk == 0:
            check("ssd", f"{tag} final state vs chunked", state,
                  ref.ssd_chunked(x, a, b, c, chunk, s0)[1], SCAN_TOL, res)
        if not timed:
            continue
        # bf16 products at the tensor cores' bf16 rate, float32 at
        # 3xTF32's; the CUDA cores' float32 bound beside each
        t_ = {"ms": cuda_ms(ssd_k.launch, x, a, b, c, reps=50),
              "device_ms": cuda_ms(ssd_k.launch, x, a, b, c, reps=50,
                                   queued=True),
              "plain_ms": cuda_ms(ref.ssd_chunked, x, a, b, c, q, reps=3)}
        ops, nbytes = ssd_k.work(bsz, t, h, p, n, q, dt)
        t_["bound_ms"], t_["bound_by"] = _bound_ms(
            nbytes, ops, PEAK_BF16_S if dt == bf16 else PEAK_3XTF32_S)
        t_["cuda_core_bound_ms"] = _bound_ms(nbytes, ops)[0]
        t_["bound_share"] = t_["bound_ms"] / t_["ms"]
        t_["shape"] = (f"x ({bsz},{t},{h},{p}) {str(dt)[6:]}, b/c "
                       f"({bsz},{t},{n})")
        if dt == f32:
            res["f32"] = t_
        else:
            res.update(t_)
        log(f"[2] ssd {t_['shape']}: {t_['ms']:.4f} ms (device "
            f"{t_['device_ms']:.4f}), plain {t_['plain_ms']:.4f} ms, bound "
            f"{t_['bound_ms']:.4f} ms ({t_['bound_by']}, "
            f"{100 * t_['bound_share']:.1f} % of it; CUDA-core bound "
            f"{t_['cuda_core_bound_ms']:.4f} ms)")

    # rg_lru: (label, B, T, D, a, b_0 scale), a = sigmoid(N(0, 1)) and
    # b = N(0, 1), or a in the model's gate range [0.9, 0.9999] with b =
    # sqrt(1 - a^2) N(0, 1); then the chunked scan's hard cases: T of 1
    # and past a tile, D of 1 and past a lane group, no decay (a = 1), a
    # = 0, a large initial state folded into b_0, and dense but permuted
    # operands ((T, B, D) storage viewed as (B, T, D))
    res = out["rg_lru"] = {}
    for label, bsz, t, d, a_kind, b0_scale in (
            ("path (RecurrentGemma prefill batch)", 4, 512, 2560, "sigmoid",
             1.0),
            ("path, gate range", 4, 512, 2560, "gate", 1.0),
            ("ragged", 3, 100, 2560, "sigmoid", 1.0),
            ("smoke widths", 2, 64, 16, "sigmoid", 1.0),
            ("odd width", 1, 37, 300, "sigmoid", 1.0),
            ("T 1", 3, 1, 300, "sigmoid", 1.0),
            ("T 129", 2, 129, 2560, "sigmoid", 1.0),
            ("D 1", 2, 300, 1, "sigmoid", 1.0),
            ("D 33", 2, 200, 33, "sigmoid", 1.0),
            ("a = 1", 2, 300, 64, "one", 1.0),
            ("a = 0", 2, 300, 64, "zero", 1.0),
            ("large initial state", 2, 300, 96, "gate", 100.0),
            ("permuted", 3, 300, 40, "sigmoid", 1.0)):
        shape = (t, bsz, d) if label == "permuted" else (bsz, t, d)
        if a_kind == "gate":
            a = 0.9 + 0.0999 * torch.rand(shape, generator=gen,
                                          device="cuda")
            b = torch.sqrt(1 - a * a) * randn(shape)
        else:
            a = {"sigmoid": lambda: torch.sigmoid(randn(shape)),
                 "one": lambda: torch.ones(shape, device="cuda"),
                 "zero": lambda: torch.zeros(shape, device="cuda")}[a_kind]()
            b = randn(shape)
        if label == "permuted":
            a, b = a.transpose(0, 1), b.transpose(0, 1)
        b[:, 0] *= b0_scale
        got = lru_k.launch(a, b)
        check("rg_lru", f"{label} ({bsz},{t},{d})", got, ref.rg_lru(a, b),
              SCAN_TOL, res)
        if label in ("path (RecurrentGemma prefill batch)", "T 129"):
            again = lru_k.launch(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"rg_lru {label}: two launches differ by "
                     f"{_max_err(got, again)}")
            res.setdefault("bitwise_repeat", []).append(label)
            log(f"[2] rg_lru {label}: two launches bitwise equal")
        if label != "path (RecurrentGemma prefill batch)":
            continue
        # timed host-issued and queued (the device alone), and queued over
        # four copies of the inputs in turn, which outrun the 50 MB L2
        copies = itertools.cycle([(a, b)] + [
            (torch.sigmoid(randn(shape)), randn(shape)) for _ in range(3)])
        res["ms"] = cuda_ms(lru_k.launch, a, b, reps=50)
        res["device_ms"] = cuda_ms(lru_k.launch, a, b, reps=50, queued=True)
        res["rotating_device_ms"] = cuda_ms(
            lambda: lru_k.launch(*next(copies)), reps=50, queued=True)
        res["plain_ms"] = cuda_ms(ref.rg_lru, a, b, reps=3)
        ops, nbytes = lru_k.work(bsz, t, d)
        res["bound_ms"], res["bound_by"] = _bound_ms(nbytes, ops)
        for key in ("ms", "device_ms", "rotating_device_ms"):
            res[key.replace("ms", "bound_share")] = res["bound_ms"] / res[key]
        res["shape"] = f"({bsz},{t},{d}) f32"
        del copies
        log(f"[2] rg_lru {res['shape']}: {res['ms']:.4f} ms (device "
            f"{res['device_ms']:.4f}, over four input copies "
            f"{res['rotating_device_ms']:.4f}), plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, {100 * res['device_bound_share']:.1f} % "
            f"of it in device time)")
    return out


def phase_train_kernels(seed: int) -> dict:
    """The training path's backward kernels against autograd of their
    plain versions on the card, every gradient within TOL (float32) or
    BF16_TOL of max(1, max |plain|), a second launch bitwise equal at
    each path case: flash_attn's at Dh 256 (RecurrentGemma's local layer,
    PaliGemma's prefix, both bf16 at 13b's batch of 2, and their float32
    twins, the shapes a user who sets the model's dtype to float32 trains
    at) and with the prefix mask (0, 1, = S, past a key tile; Dh 64 and
    128 on the tensor cores), Dh 256 in float32 (phase 2's timed case, S
    off the 16-row tiles, a window whose first key tile is partial,
    bidirectional); ssd's at Mamba-2's training batch in bf16 and float32
    and its hard cases (forward chunk 1, no decay, decays that underflow,
    an initial state x100 with its gradient, a final state's gradient, P
    and N off 32, and in float32 too T off the chunk with heads off the
    group, P and N off the tiles); rg_lru's at RecurrentGemma's
    training batch and its hard cases (T 1 and 129, a = 0, a = 1,
    permuted operands). The path cases are timed host-issued and queued
    beside the plain backward versions (`ref.flash_attn_bwd`,
    `ref.ssd_bwd`, `ref.rg_lru_bwd`), the bounds of `bwd_work` and, for
    flash_attn, SDPA's backward with the same boolean mask (its forward
    and backward less its forward; a yardstick, not on the path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as lru_k
    from repro_torch.kernels import ssd as ssd_k
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 400)

    def randn(shape, dtype=f32, scale=1.0, grad=False):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)
        return x.requires_grad_() if grad else x

    def check(name, label, got, want, tol, res):
        torch.cuda.synchronize()
        worst = max((_rel_err(g, w) for g, w in zip(got, want)),
                    key=lambda e: e[1])
        if not worst[1] <= tol:
            fail(f"{name} {label}: kernel vs autograd of plain error "
                 f"{worst[0]:.3g} ({worst[1]:.3g} of max |plain|, limit "
                 f"{tol})")
        key = "bf16_max_abs_err" if got[0].dtype == bf16 else "max_abs_err"
        res[key] = max(res.get(key, 0.0), worst[0])
        log(f"[2] {name} {label}: max err {worst[0]:.3g} ({worst[1]:.3g} "
            f"of max |plain|, limit {tol})")

    def repeat(name, label, fn, res):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)
                   if a is not None):
            fail(f"{name} {label}: two launches differ")
        res.setdefault("bitwise_repeat", []).append(label)
        log(f"[2] {name} {label}: two launches bitwise equal")

    def timing(name, res, fn, plain, ops, nbytes, peak, shape, **extra):
        t = {"ms": cuda_ms(fn, reps=10),
             "device_ms": cuda_ms(fn, reps=10, queued=True),
             "plain_ms": cuda_ms(plain, reps=2), "shape": shape, **extra}
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, ops, peak)
        t["cuda_core_bound_ms"] = _bound_ms(nbytes, ops)[0]
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        res.update(t)
        lib = (f", SDPA backward {t['library_bwd_device_ms']:.4f} ms "
               f"(device; forward + backward {t['library_ms']:.4f} "
               f"host-issued)" if "library_ms" in t else "")
        log(f"[2] {name} {shape}: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms{lib}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_share']:.1f} % of it in device time; "
            f"CUDA-core bound {t['cuda_core_bound_ms']:.4f} ms)")

    out = {}
    # flash_attn: (label, BH, S, Dh, group, dtype, causal, window, prefix,
    # timed as); the paths at 13b's batch of 2
    res = out["flash_attn_bwd_dh256"] = {}
    for (label, bh, s, dh, group, dt, causal, window, prefix, timed) in (
            ("path recurrentgemma_2b local", 20, 512, 256, 10, bf16, True,
             2048, 0, "local"),
            ("path paligemma_3b prefix", 16, 768, 256, 8, bf16, True, 0,
             256, "prefix"),
            ("local in float32", 20, 512, 256, 10, f32, True, 2048, 0,
             "local_f32"),
            ("prefix in float32", 16, 768, 256, 8, f32, True, 0, 256,
             "prefix_f32"),
            ("prefix 0", 8, 300, 256, 2, bf16, True, 0, 0, None),
            ("prefix 1", 8, 300, 256, 2, f32, True, 0, 1, None),
            ("prefix = S", 8, 300, 256, 2, f32, True, 0, 300, None),
            ("prefix past a key tile", 8, 300, 256, 2, f32, True, 0, 97,
             None),
            ("Dh 256 f32 causal", 8, 300, 256, 2, f32, True, 0, 0, "f32"),
            ("Dh 256 f32 bidirectional", 8, 200, 256, 1, f32, False, 0, 0,
             None),
            ("Dh 256 f32 window 70", 8, 200, 256, 2, f32, True, 70, 0,
             None),
            ("Dh 256 f32 S off the 16-row tiles, group 3", 6, 83, 256, 3,
             f32, True, 0, 0, None),
            ("Dh 256 f32 window 23 (first 16-key tile partial)", 4, 90, 256,
             2, f32, True, 23, 0, None),
            ("Dh 256 f32 bidirectional S off 16", 2, 53, 256, 1, f32, False,
             0, 0, None),
            ("bf16 S off 64, group 3", 6, 150, 256, 3, bf16, True, 0, 0,
             None),
            ("bf16 window 70 (first tile partial)", 4, 200, 256, 2, bf16,
             True, 70, 0, None),
            ("bf16 prefix past a tile", 4, 300, 256, 1, bf16, True, 0, 97,
             None),
            ("bf16 bidirectional S off 64", 2, 77, 256, 1, bf16, False, 0,
             0, None),
            ("Dh 64 f32 prefix 100", 12, 300, 64, 3, f32, True, 0, 100,
             None),
            ("Dh 128 bf16 prefix 65", 4, 300, 128, 1, bf16, True, 0, 65,
             None)):
        q = randn((bh, s, dh), dt, grad=True)
        k, v = (randn((bh // group, s, dh), dt, grad=True) for _ in "kv")
        do = randn((bh, s, dh), dt)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        got = torch.autograd.grad(fa.flash_attn(q, k, v, **kw), (q, k, v),
                                  do)
        want = torch.autograd.grad(ref.flash_attn(q, k, v, **kw), (q, k, v),
                                   do)
        tol = TOL if dt == f32 else BF16_TOL
        check("flash_attn backward", f"{label} ({bh},{s},{dh}) group "
              f"{group} {str(dt)[6:]}", got, want, tol, res)
        if not timed:
            continue
        q, k, v = q.detach(), k.detach(), v.detach()
        o = fa.launch(q, k, v, causal, window, prefix)
        args = (q, k, v, o, do, causal, window, prefix)
        repeat("flash_attn backward", label, lambda: fa.launch_bwd(*args),
               res)
        # SDPA on (B, heads, S, Dh) with k, v repeated to the heads and the
        # same mask as a boolean (True: kept)
        b_ = 2
        qs = q.reshape(b_, bh // b_, s, dh).clone().requires_grad_()
        ks, vs = (x.reshape(b_, bh // group // b_, s, dh)
                  .repeat_interleave(group, dim=1).clone().requires_grad_()
                  for x in (k, v))
        dos = do.reshape(b_, bh // b_, s, dh)
        mask = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
        if window:
            mask = mask.triu(1 - window)
        mask[:, :prefix] = True

        def sdpa_fwd_bwd():
            return torch.autograd.grad(
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                (qs, ks, vs), dos)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=mask)
        lib = {"library_ms": cuda_ms(sdpa_fwd_bwd, reps=10),
               "library_device_ms": cuda_ms(sdpa_fwd_bwd, reps=10,
                                            queued=True),
               "library_fwd_device_ms": cuda_ms(sdpa_fwd, reps=10,
                                                queued=True)}
        lib["library_bwd_device_ms"] = (lib["library_device_ms"]
                                        - lib["library_fwd_device_ms"])
        ops, nbytes = fa.bwd_work(q.shape, k.shape[0], dt, causal, window,
                                  prefix)
        sub = res[timed] = {}
        timing("flash_attn backward", sub, lambda: fa.launch_bwd(*args),
               lambda: ref.flash_attn_bwd(q, k, v, o, do, causal=causal,
                                          window=window, prefix_len=prefix),
               ops, nbytes, PEAK_BF16_S if dt == bf16 else PEAK_3XTF32_S,
               f"({bh},{s},{dh}) group {group} {str(dt)[6:]} "
               + (f"prefix {prefix}" if prefix else f"window {window}"),
               **lib)
        del qs, ks, vs, sdpa_fwd_bwd, sdpa_fwd

    # ssd: (label, B, T, H, P, N, dtype, decay, state0, dstate, forward
    # chunk, timed as); Mamba-2's log decays dt * -exp(a_log) run from
    # about -0.1 to -11
    res = out["ssd_bwd"] = {}
    for (label, bsz, t, h, p, n, dt, decay, s0, dst, chunk, timed) in (
            ("path (Mamba-2 training)", 2, 512, 80, 64, 128, bf16, "rand",
             False, False, 128, "path"),
            ("path f32", 2, 512, 80, 64, 128, f32, "rand", False, False, 128,
             "f32"),
            ("forward chunk 1", 1, 70, 4, 64, 128, f32, "rand", False, False,
             1, None),
            ("no decay", 1, 150, 4, 64, 128, f32, "none", False, True, 128,
             None),
            ("underflowing decays", 1, 150, 4, 64, 128, f32, "underflow",
             False, True, 128, None),
            ("state0 x100 with its gradient", 2, 200, 4, 64, 128, f32,
             "rand", True, True, 128, None),
            ("final-state gradient bf16", 1, 200, 4, 64, 128, bf16, "rand",
             True, True, 128, None),
            ("P, N off 32", 1, 77, 3, 5, 7, f32, "rand", True, True, 128,
             None),
            ("f32 T off the chunk, heads off the group", 2, 150, 13, 64, 128,
             f32, "rand", True, True, 128, None),
            ("f32 P, N off the tiles, underflowing decays", 2, 100, 6, 40,
             96, f32, "underflow", False, True, 128, None),
            ("bf16 T off the chunk, heads off the group", 2, 150, 7, 64,
             128, bf16, "rand", True, True, 128, None),
            ("bf16 P, N off the tiles", 1, 77, 3, 5, 7, bf16, "rand", True,
             True, 128, None),
            ("bf16 P past a state slice, underflowing decays", 2, 100, 6,
             40, 96, bf16, "underflow", False, True, 128, None)):
        x = randn((bsz, t, h, p), dt, grad=True)
        b, c = (randn((bsz, t, n), dt, grad=True) for _ in "bc")
        u = torch.rand((bsz, t, h), generator=gen, device="cuda")
        a = {"rand": -0.1 - 2.0 * u, "none": 0.0 * u,
             "underflow": -50.0 - u}[decay].requires_grad_()
        st0 = (randn((bsz, h, p, n), scale=100.0, grad=True) if s0
               else None)
        ins = [z for z in (x, a, b, c, st0) if z is not None]
        dy, ds = randn((bsz, t, h, p), dt), randn((bsz, h, p, n))

        def loss(y, st):
            return (y.float() * dy.float()).sum() \
                + ((st * ds).sum() if dst else 0)
        got = torch.autograd.grad(
            loss(*ssd_k.ssd_chunked(x, a, b, c, chunk=chunk, state0=st0)),
            ins)
        want = torch.autograd.grad(loss(*ref.ssd(x, a, b, c, state0=st0)),
                                   ins)
        check("ssd backward", f"{label} ({bsz},{t},{h},{p}) N {n} "
              f"{str(dt)[6:]}", got, want, TOL if dt == f32 else BF16_TOL,
              res)
        del got, want
        if not timed:
            continue
        args = [z.detach() for z in (x, a, b, c)] + [dy]
        repeat("ssd backward", label, lambda: ssd_k.launch_bwd(*args), res)
        ops, nbytes = ssd_k.bwd_work(bsz, t, h, p, n, dt)
        sub = res if timed == "path" else res.setdefault(timed, {})
        timing("ssd backward", sub, lambda: ssd_k.launch_bwd(*args),
               lambda: ref.ssd_bwd(*args), ops, nbytes,
               PEAK_BF16_S if dt == bf16 else PEAK_3XTF32_S,
               f"({bsz},{t},{h},{p}) N {n} {str(dt)[6:]}")

    # rg_lru: (label, B, T, D, fill, timed); the gate range a = exp(-8 r
    # softplus(Lambda)) of the model
    res = out["rg_lru_bwd"] = {}
    for (label, bsz, t, d, fill, timed) in (
            ("path (RecurrentGemma training)", 2, 512, 2560, "gate", True),
            ("T 1", 2, 1, 2560, "rand", False),
            ("T 129", 2, 129, 300, "rand", False),
            ("a = 0", 2, 100, 70, "zero", False),
            ("a = 1", 2, 100, 70, "one", False),
            ("permuted operands", 3, 300, 70, "perm", False)):
        u = torch.rand((bsz, t, d), generator=gen, device="cuda")
        if fill == "perm":
            base = torch.rand((t, bsz, d), generator=gen, device="cuda") \
                .requires_grad_()
            a = base.transpose(0, 1)
            bb = randn((d, t, bsz), grad=True)
            b = bb.permute(2, 1, 0)
            ins = (base, bb)
        else:
            a = {"rand": u, "zero": 0.0 * u, "one": 1.0 + 0.0 * u,
                 "gate": torch.exp(-8.0 * u * 0.7)}[fill].requires_grad_()
            b = randn((bsz, t, d), grad=True)
            ins = (a, b)
        dh = randn((bsz, t, d))
        got = torch.autograd.grad(lru_k.rg_lru_scan(a, b), ins, dh)
        want = torch.autograd.grad(ref.rg_lru(a, b), ins, dh)
        check("rg_lru backward", f"{label} ({bsz},{t},{d})", got, want,
              SCAN_TOL, res)
        if not timed:
            continue
        a, b = a.detach(), b.detach()
        h = lru_k.launch(a, b)
        repeat("rg_lru backward", label, lambda: lru_k.launch_bwd(a, h, dh),
               res)
        ops, nbytes = lru_k.bwd_work(bsz, t, d)
        timing("rg_lru backward", res, lambda: lru_k.launch_bwd(a, h, dh),
               lambda: ref.rg_lru_bwd(a, h, dh), ops, nbytes, PEAK_OPS_S,
               f"({bsz},{t},{d}) f32")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

PHASES = ((1, 1, 2), (3, 12, 16))
CPU_LAYERS = 1                 # phase-2 depth of the card-vs-CPU check
# its rows: cut from BATCH = 4 so that the script, phases 10-12
# included, stays well inside its time limit on the slowest hosts (at 4
# rows the host CPU's forwards took 146 s of a 1,067 s run beside an
# H100; cut to 2, then to 1 when phase 12 took a slow host's script to
# 1,074 s, PERF.md §6)
CPU_ROWS = 1
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


def _device_events(prof) -> list:
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _event_ms(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3


def profiled(fn):
    """fn() under torch.profiler (CUDA activity only), ending in a
    synchronize: (its result, wall s, summed kernel ms, {kernel name:
    (ms, count)} of the seven hand-written kernels and of the four
    costliest kernels under "top: <name>")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = _device_events(prof)
    ours = {}
    for e in events:
        for name in ("flash_attn", "entropy_head", "mlp_softmax_attn",
                     "ring_matmul", "secure_matmul", "ssd", "rg_lru"):
            # flash_attn_kernel<...>, entropy_head_split_kernel<...>, ...
            if re.search(rf"\b{name}_(?:\w+_)?kernel\b", e.key):
                ms, n = ours.get(name, (0.0, 0))
                ours[name] = (ms + _event_ms(e), n + e.count)
    for e in sorted(events, key=_event_ms, reverse=True)[:4]:
        ours[f"top: {e.key[:90]}"] = (_event_ms(e), e.count)
    return out, wall, sum(_event_ms(e) for e in events), ours


def phase_profile(seed: int, proxies) -> dict:
    """Where one phase-2 wave's device time goes: one wave of WAVE batches
    on each ring (RING64, then RING32) under torch.profiler (CUDA
    activity only: the CPU side adds an event per aten op and multiplies
    the trace), after the main path's launch counts were read. Busy
    share = summed kernel time / wall time of the wave (one stream, so
    kernels do not overlap). The bitwise kernels (xor/and/or functors and
    shifts) are nearly all the threefry hash's; its adds, shared with the
    Beaver arithmetic, are not split out. RING32's projections combine
    in secure_matmul, RING64's in ring_matmul."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32, RING64
    cfg, specs, pps = proxies
    pool = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (WAVE * BATCH, SEQ))
    res = {}
    for ring in (RING64, RING32):
        ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=ring,
                                     device=DEVICE))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            ex.score_phase(prng.key(seed + 5, device=DEVICE), pps[1], cfg,
                           pool, specs[1])
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        kernels = _device_events(prof)
        ms = _event_ms

        def share(*words):
            return sum(ms(e) for e in kernels
                       if any(w in e.key for w in words))

        busy = sum(ms(e) for e in kernels)
        out = {"wave_wall_ms": wall_ms, "kernel_ms": busy,
               "busy_share": busy / wall_ms,
               "gemm_kernels_ms": share("ring_matmul_kernel",
                                        "secure_matmul_kernel"),
               "secure_matmul_ms": share("secure_matmul_kernel"),
               "secure_matmul_launches": sum(
                   e.count for e in kernels
                   if "secure_matmul_kernel" in e.key),
               "bitwise_kernels_ms": share("Bitwise", "shift_kernel"),
               "top": [(e.key[:100], ms(e), e.count) for e in
                       sorted(kernels, key=ms, reverse=True)[:6]]}
        log(f"[3p] {ring.name} one phase-2 wave ({WAVE} batches, "
            f"profiled): " + json.dumps(out))
        res[ring.name] = out
    return res


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(seed: int, proxies) -> None:
    import numpy as np
    import torch
    from repro_torch.core.proxy import ProxySpec, share_proxy
    from repro_torch.core.tree import tree_leaves, tree_rebuild
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
                                                   (CPU_ROWS, SEQ))
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


# ---------------------------------------------------------------------------
# phase 6: the clear scoring paths at full width
# ---------------------------------------------------------------------------

TARGET_POOL, TARGET_TEST, TARGET_BATCH, TARGET_KEEP = 64, 64, 16, 8


def _report(tag, name, wall, kernel_ms, ours, smi) -> dict:
    info = {"wall_s": wall, "device_kernel_ms": kernel_ms,
            "device_busy_share": kernel_ms / (wall * 1e3),
            "kernels": {k: {"ms": v[0], "count": v[1]}
                        for k, v in ours.items()}}
    log(f"[{tag}] {name} ({smi}): " + json.dumps(info))
    return info


def phase_target(seed: int, smi: str) -> dict:
    """The Oracle selection and the accuracy readout of the BERT-base
    target on the card, then one batch at depth 1 against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import target, tree
    from repro_torch.data.tasks import make_classification_task
    from repro_torch.kernels import ops as kops
    from repro_torch.models.transformer import layer_slice
    task = make_classification_task(seed, n_pool=TARGET_POOL,
                                    n_test=TARGET_TEST, seq=SEQ,
                                    vocab=BERT.vocab_size, n_classes=CLASSES)
    t0 = time.time()
    params = target.init_classifier(
        torch.Generator(device=DEVICE).manual_seed(seed), BERT, CLASSES,
        device=DEVICE)
    torch.cuda.synchronize()
    log(f"[6a] BERT-base target: random weights on the card in "
        f"{time.time() - t0:.2f} s")
    pool = task.pool_tokens

    def run():
        ents = torch.cat([target.prediction_entropy(params, BERT,
                                                    pool[i:i + TARGET_BATCH])
                          for i in range(0, len(pool), TARGET_BATCH)])
        acc = target.accuracy(params, BERT, task.test_tokens,
                              task.test_labels)
        return ents, acc

    for reset in (kops.reset_fa_stats, kops.reset_eh_stats):
        reset()
    (ents, acc), wall, kernel_ms, ours = profiled(run)
    fa, eh = kops.fa_stats(), kops.eh_stats()
    batches = -(-TARGET_POOL // TARGET_BATCH) + 1    # scored + accuracy
    top = np.sort(np.argsort(ents.cpu().numpy())[-TARGET_KEEP:])
    info = _report("6a", f"Oracle ({TARGET_POOL} candidates, batches of "
                   f"{TARGET_BATCH}) + accuracy ({TARGET_TEST})", wall,
                   kernel_ms, ours, smi)
    info.update(launches={"flash_attn": fa, "entropy_head": eh},
                oracle_top=top.tolist(), accuracy=acc)
    log(f"[6a] launches flash_attn {fa}, entropy_head {eh}; Oracle keeps "
        f"{top.tolist()}; accuracy {acc:.4f}")
    if fa != {"kernel": BERT.n_layers * batches, "ref": 0}:
        fail(f"target: flash_attn {fa}, want {BERT.n_layers * batches} "
             "kernel launches and no plain call")
    if eh["kernel"] <= 0 or eh["ref"]:
        fail(f"target: entropy_head {eh}")
    if ents.shape != (TARGET_POOL,) or not torch.isfinite(ents).all():
        fail(f"target: entropy of shape {tuple(ents.shape)} or not finite")
    if not 0.0 <= acc <= 1.0:
        fail(f"target: accuracy {acc}")

    cpu = tree.to_device({k: (layer_slice(v, slice(0, CPU_LAYERS))
                              if k == "layers" else v)
                          for k, v in params.items() if k != "unembed"},
                         "cpu")
    tok = pool[:TARGET_BATCH]
    t0 = time.time()
    want = (target.classifier_logits(cpu, BERT, tok, n_layers=CPU_LAYERS),
            target.prediction_entropy(cpu, BERT, tok, n_layers=CPU_LAYERS))
    cpu_s = time.time() - t0
    got = (target.classifier_logits(params, BERT, tok, n_layers=CPU_LAYERS),
           target.prediction_entropy(params, BERT, tok, n_layers=CPU_LAYERS))
    errs = [_rel_err(g.cpu(), w) for g, w in zip(got, want)]
    log(f"[6a] card vs CPU at depth {CPU_LAYERS} (CPU {cpu_s:.1f} s): "
        f"logits max err {errs[0][0]:.3g}, entropy max err {errs[1][0]:.3g}")
    if max(rel for _, rel in errs) > TOL:
        fail(f"target: card and CPU differ by {errs} (limit {TOL})")
    info["card_vs_cpu_max_err"] = max(err for err, _ in errs)
    return info


def phase_clear_sieve(seed: int, proxies, sieve, smi: str) -> dict:
    """The two-phase clear sieve on ClearEngine at BERT-base width, then
    one phase-2 batch against the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import tree
    from repro_torch.core.selection import _phase_keep, clear_phase
    from repro_torch.engine import FULL_VARIANT, ClearEngine, proxy_entropy
    from repro_torch.kernels import ops as kops
    from repro_torch.mpc.ring import RING32, RING64
    cfg, specs, pps = proxies
    specs = [dataclasses.replace(specs[0], selectivity=KEEPS[0] / POOL),
             *specs[1:]]
    keeps = _phase_keep(POOL, KEEPS[-1], specs)
    if keeps != list(KEEPS):
        fail(f"clear sieve: keeps {keeps}, want {list(KEEPS)}")
    pool = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (POOL, SEQ))

    def run():
        surviving, phases = np.arange(POOL), []
        for spec, pp, keep in zip(specs, pps, keeps):
            n = len(surviving)
            surviving, appraisal, ents = clear_phase(
                ClearEngine(), pp, cfg, pool, surviving, spec, keep,
                FULL_VARIANT, batch=BATCH)
            if ents.shape != (n,) or not np.isfinite(ents).all():
                fail(f"clear sieve: scores of shape {ents.shape} or not "
                     "finite")
            phases.append({"candidates": n, "keep": keep,
                           "appraisal": appraisal,
                           "survivors": surviving.tolist()})
        return phases

    kops.reset_msa_stats()
    kops.reset_eh_stats()
    phases, wall, kernel_ms, ours = profiled(run)
    msa = kops.msa_stats()
    want = sum(spec.n_layers * -(-p["candidates"] // BATCH)
               for spec, p in zip(specs, phases))
    info = _report("6b", f"clear sieve {POOL} -> {' -> '.join(map(str, keeps))}"
                   f" (batch {BATCH})", wall, kernel_ms, ours, smi)
    info.update(phases=phases, launches={"mlp_softmax_attn": msa})
    msa_ms, msa_n = ours.get("mlp_softmax_attn", (0.0, 0))
    info["mlp_softmax_attn_ms"] = msa_ms
    log(f"[6b] launches mlp_softmax_attn {msa} (want {want}), "
        f"entropy_head {kops.eh_stats()}; mlp_softmax_attn {msa_ms:.3f} ms "
        f"of {kernel_ms:.3f} ms of kernels ({msa_n} profiled launches)")
    if msa != {"kernel": want, "ref": 0}:
        fail(f"clear sieve: mlp_softmax_attn {msa}, want {want} kernel "
             "launches and no plain call")
    overlap = {ring.name: len(set(phases[-1]["survivors"])
                              & set(sieve[ring.name]["phases"][-1]
                                    ["survivors"]))
               for ring in (RING32, RING64)}
    info["overlap_with_mpc"] = overlap
    log(f"[6b] clear survivors {phases[-1]['survivors']}; shared with the "
        f"MPC sieve's (of {KEEPS[-1]}): {overlap}")

    tok = pool[np.asarray(phases[0]["survivors"])[:BATCH]]
    got = proxy_entropy(ClearEngine(), pps[1], cfg,
                        torch.as_tensor(tok, device=DEVICE), specs[1])
    cpu_pp = tree.to_device(pps[1], "cpu")
    t0 = time.time()
    want_s = proxy_entropy(ClearEngine(), cpu_pp, cfg, torch.as_tensor(tok),
                           specs[1])
    err, rel = _rel_err(got.cpu(), want_s)
    log(f"[6b] card vs CPU, one phase-2 batch (CPU {time.time() - t0:.1f} "
        f"s): max err {err:.3g}")
    if rel > TOL:
        fail(f"clear sieve: card and CPU scores differ by {err} "
             f"(limit {TOL})")
    info["card_vs_cpu_max_err"] = err
    return info


# ---------------------------------------------------------------------------
# phase 7: token serving at full width
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 8, 4, 512, 16
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW
CPU_DECODE_STEPS = 4           # decode steps of the card-vs-CPU check


def _cut_depth(params, cfg):
    """The first layer (ssm, dense, moe, vlm; the encdec family's first
    encoder and first decoder layer) or the first block pattern (hybrid)
    of a full-width model, in float32: the depth the CPU side can
    afford."""
    import dataclasses
    from repro_torch.models.transformer import layer_slice
    out = {k: v for k, v in params.items()
           if k not in ("layers", "enc_layers", "rec_layers",
                        "attn_layers")}
    if cfg.family != "hybrid":
        out["layers"] = layer_slice(params["layers"], slice(0, 1))
        if cfg.family == "encdec":
            out["enc_layers"] = layer_slice(params["enc_layers"],
                                            slice(0, 1))
        return out, dataclasses.replace(
            cfg, n_layers=1, n_enc_layers=min(cfg.n_enc_layers, 1),
            dtype="float32")
    pat = cfg.block_pattern
    out["rec_layers"] = layer_slice(params["rec_layers"],
                                    slice(0, pat.count("rec")))
    out["attn_layers"] = layer_slice(params["attn_layers"],
                                     slice(0, pat.count("attn")))
    return out, dataclasses.replace(cfg, n_layers=len(pat), dtype="float32")


def phase_serve(seed: int, smi: str) -> dict:
    """Token serving at full width: for mamba2_2_7b, then
    recurrentgemma_2b, random weights from --seed on the card and the
    port's Server; 8 requests of 512-token prompts on 4 slots, max_new 16,
    max_len 528 (two prefill batches of 4 x 512, 15 decode steps each).
    Prefill must launch ssd once an ssm layer, or rg_lru once a recurrent
    layer and flash_attn once an attention layer (a local window of 2048
    covers the 512-token prompt), a batch, and take no plain version. One
    prefill batch and one decode step are then profiled, and the card is
    held against the CPU
    on one request (prefill logits and the first decode steps, depth cut,
    float32) within TOL of max |CPU|."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import transformer as T
    counters = {"ssd": (kops.ssd_stats, kops.reset_ssd_stats),
                "rg_lru": (kops.lru_stats, kops.reset_lru_stats),
                "flash_attn": (kops.fa_stats, kops.reset_fa_stats)}
    results = {}
    for arch in ("mamba2_2_7b", "recurrentgemma_2b"):
        t_arch = time.time()
        cfg = load_arch(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = T.init_params(
            torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in tree.tree_leaves(params))
        init_s = time.time() - t0
        log(f"[7] {arch}: {n_params / 1e9:.3f} B parameters "
            f"({n_params * 4 / 1e9:.1f} GB float32) drawn on the card in "
            f"{init_s:.2f} s")
        sc = ServeConfig(arch=arch, smoke=False, slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, max_new=SERVE_NEW, seed=seed)
        srv = Server(sc, device=DEVICE, params=params)
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, cfg.vocab_size,
                               (SERVE_REQUESTS, SERVE_PROMPT))
        for _, reset in counters.values():
            reset()
        out = srv.run([Request(i, p) for i, p in enumerate(prompts)])
        launches = {k: stats() for k, (stats, _) in counters.items()}
        kinds = cfg._layer_kinds()
        batches = -(-SERVE_REQUESTS // SERVE_SLOTS)
        want = {"ssd": kinds.count("ssd") * batches,
                "rg_lru": kinds.count("rec") * batches,
                "flash_attn": kinds.count("attn") * batches}
        info = {k: out[k] for k in ("requests", "tokens", "tok_per_s",
                                    "wall_s", "prefill_s", "decode_s")}
        info.update(params_b=n_params / 1e9, init_s=init_s,
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches=launches)
        log(f"[7] {arch} serve ({smi}): " + json.dumps(info))
        for k, n in want.items():
            if launches[k] != {"kernel": n, "ref": 0}:
                fail(f"{arch}: {k} {launches[k]}, want {n} kernel launches "
                     "and no plain call")
        outs = out["outputs"]
        if (out["requests"] != SERVE_REQUESTS or sorted(outs) !=
                list(range(SERVE_REQUESTS))
                or any(len(o) != SERVE_NEW or min(o) < 0
                       or max(o) >= cfg.vocab_size for o in outs.values())):
            fail(f"{arch}: outputs {outs}")
        log(f"[7] {arch} first request's tokens: {outs[0]}")

        batch = {"tokens": torch.as_tensor(prompts[:SERVE_SLOTS],
                                           device=DEVICE)}

        def prefill_once():
            with torch.no_grad():
                return T.prefill(params, cfg, batch, max_len=SERVE_MAX_LEN)
        (lg, cache), wall, kernel_ms, ours = profiled(prefill_once)
        if not torch.isfinite(lg.float()).all():
            fail(f"{arch}: non-finite prefill logits")
        info["profile"] = _report("7p", f"{arch} one prefill batch "
                                  f"({SERVE_SLOTS} x {SERVE_PROMPT})", wall,
                                  kernel_ms, ours, smi)
        step = {"tokens": lg.argmax(-1)[:, None]}

        def decode_once():
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, step, SERVE_PROMPT)
        (lg, _), wall, kernel_ms, ours = profiled(decode_once)
        if not torch.isfinite(lg.float()).all():
            fail(f"{arch}: non-finite decode logits")
        info["decode_profile"] = _report(
            "7p", f"{arch} one decode step ({SERVE_SLOTS} slots)", wall,
            kernel_ms, ours, smi)

        # the card against the CPU on one request, depth cut, float32
        cut, cut_cfg = _cut_depth(params, cfg)
        tok = np.concatenate([prompts[:1], rng.integers(
            0, cfg.vocab_size, (1, CPU_DECODE_STEPS))], axis=1)
        got = {}
        for dev, p in ((DEVICE, cut), ("cpu", tree.to_device(cut, "cpu"))):
            t0 = time.time()
            with torch.no_grad():
                lg, cache = T.prefill(p, cut_cfg,
                                      {"tokens": tok[:, :SERVE_PROMPT]},
                                      max_len=SERVE_MAX_LEN)
                logits = [lg]
                for j in range(CPU_DECODE_STEPS):
                    pos = SERVE_PROMPT + j
                    lg, cache = T.decode_step(
                        p, cut_cfg, cache, {"tokens": tok[:, pos:pos + 1]},
                        pos)
                    logits.append(lg)
            got[dev] = torch.stack(logits).cpu()
            log(f"[7] {arch} depth {cut_cfg.n_layers} float32 prefill + "
                f"{CPU_DECODE_STEPS} decode steps on {dev}: "
                f"{time.time() - t0:.1f} s")
        err, _ = _rel_err(got[DEVICE], got["cpu"])
        rel = err / float(got["cpu"].abs().max())
        log(f"[7] {arch} card vs CPU: max err {err:.3g} ({rel:.3g} of max "
            f"|CPU|, limit {TOL})")
        if not rel <= TOL:
            fail(f"{arch}: card and CPU logits differ by {err} ({rel} of "
                 f"max |CPU|, limit {TOL})")
        info["card_vs_cpu_max_err"] = err
        results[arch] = info
        del params, srv, cut, got, lg, cache
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[7] {arch} phase: {time.time() - t_arch:.1f} s")
    return results


# ---------------------------------------------------------------------------
# phase 7b: the rest of the model zoo's serving path at full width
# ---------------------------------------------------------------------------

ZOO_REQUESTS = ZOO_SLOTS = 4   # one prefill batch of 4 x ZOO_PROMPT
ZOO_PROMPT, ZOO_NEW = 512, 8
ZOO_INT8_STEPS = 4             # int8 decode steps held to the JAX gate
WHISPER_FRAMES = 1500          # openai/whisper-small max_source_positions
WHISPER_PROMPT = 64


def _zoo_batch(cfg, rng, rows: int, prompt: int) -> dict:
    """Tokens, and the stub image patches (vlm) or audio frames (encdec)
    the families take beside them, drawn from `rng` (numpy)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, prompt))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (rows, cfg.n_prefix_tokens, cfg.d_model)).astype("float32")
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (rows, WHISPER_FRAMES, cfg.d_model)).astype("float32")
    return batch


def _zoo_attn_layers(cfg) -> int:
    """flash_attn launches of one prefill batch: one a self-attention
    layer, and for encdec one an encoder layer and one a cross-attention
    layer."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def phase_zoo_serve(seed: int, smi: str) -> dict:
    """The zoo's other families at full width and depth, random weights
    from --seed drawn on the card: qwen2_0_5b (dense) and granite_moe_3b
    (moe) through the port's Server, 4 requests of 512-token prompts on 4
    slots, 8 new tokens (one prefill batch, 7 decode steps); qwen2_0_5b
    again with an int8 KV cache, prefill and 4 teacher-forced decode
    steps held to the JAX package's own gate against its bf16
    teacher-forced logits (correlation > 0.99, max |diff| < 0.2,
    tests/test_models.py); paligemma_3b (vlm, 256 stub patches + 512
    tokens, the prefix mask) and whisper_small (encdec, 1,500 stub
    frames, a 64-token prompt) through T.prefill and 7 greedy
    T.decode_steps on 4 rows. Each main-path run must launch flash_attn
    once an attention layer (whisper: encoder, decoder and cross) and
    take no plain version, give finite logits and tokens inside the
    vocabulary; one prefill batch and one decode step are profiled; and
    the card is held against the CPU on one row, depth cut to one layer,
    float32, prefill and 4 decode steps, within TOL of max |CPU|."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import transformer as T
    results = {}

    def gate_launches(arch, cfg, batches):
        launches = kops.fa_stats()
        want = _zoo_attn_layers(cfg) * batches
        if launches != {"kernel": want, "ref": 0}:
            fail(f"{arch}: flash_attn {launches}, want {want} kernel "
                 "launches and no plain call")
        return launches["kernel"]

    def gate_outputs(arch, cfg, outs):
        if (len(outs) != ZOO_REQUESTS
                or any(len(o) != ZOO_NEW or min(o) < 0
                       or max(o) >= cfg.vocab_size for o in outs)):
            fail(f"{arch}: outputs {outs}")

    def finite(arch, what, lg):
        if not torch.isfinite(lg.float()).all():
            fail(f"{arch}: non-finite {what} logits")

    for arch in ("qwen2_0_5b", "granite_moe_3b", "paligemma_3b",
                 "whisper_small"):
        t_arch = time.time()
        cfg = load_arch(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = T.init_params(
            torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in tree.tree_leaves(params))
        info = {"params_b": n_params / 1e9, "init_s": time.time() - t0}
        log(f"[7b] {arch}: {n_params / 1e9:.3f} B parameters "
            f"({n_params * 4 / 1e9:.1f} GB float32) drawn on the card in "
            f"{info['init_s']:.2f} s")
        rng = np.random.default_rng(seed)
        prompt = WHISPER_PROMPT if cfg.family == "encdec" else ZOO_PROMPT
        batch = _zoo_batch(cfg, rng, ZOO_REQUESTS, prompt)
        prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        max_len = prefix + prompt + ZOO_NEW
        kops.reset_fa_stats()
        if cfg.family in ("dense", "moe"):
            sc = ServeConfig(arch=arch, smoke=False, slots=ZOO_SLOTS,
                             max_len=max_len, max_new=ZOO_NEW, seed=seed)
            out = Server(sc, device=DEVICE, params=params).run(
                [Request(i, p) for i, p in enumerate(batch["tokens"])])
            info.update({k: out[k] for k in ("requests", "tokens",
                                             "tok_per_s", "wall_s",
                                             "prefill_s", "decode_s")})
            outs = [out["outputs"][i] for i in range(ZOO_REQUESTS)]
        else:
            # the JAX Server feeds only tokens: these families run through
            # the entry points, greedy, as the Server would
            with torch.no_grad():
                t1 = time.time()
                lg, cache = T.prefill(params, cfg, batch, max_len=max_len)
                step = lg.argmax(-1)[:, None]
                toks = [step[:, 0].tolist()]
                torch.cuda.synchronize()
                t2 = time.time()
                for j in range(ZOO_NEW - 1):
                    lg, cache = T.decode_step(params, cfg, cache,
                                              {"tokens": step},
                                              prefix + prompt + j)
                    step = lg.argmax(-1)[:, None]
                    toks.append(step[:, 0].tolist())
                torch.cuda.synchronize()
                t3 = time.time()
            finite(arch, "decode", lg)
            outs = [list(r) for r in zip(*toks)]
            tokens = (ZOO_NEW - 1) * ZOO_REQUESTS
            info.update(requests=ZOO_REQUESTS, tokens=tokens,
                        tok_per_s=tokens / (t3 - t1), wall_s=t3 - t1,
                        prefill_s=t2 - t1, decode_s=t3 - t2)
        info["launches"] = {"flash_attn": gate_launches(arch, cfg, 1)}
        gate_outputs(arch, cfg, outs)
        info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[7b] {arch} serve ({smi}): " + json.dumps(info))
        log(f"[7b] {arch} first row's tokens: {outs[0]}")

        def prefill_once():
            with torch.no_grad():
                return T.prefill(params, cfg, batch, max_len=max_len)
        (lg, cache), wall, kernel_ms, ours = profiled(prefill_once)
        finite(arch, "prefill", lg)
        info["profile"] = _report(
            "7b", f"{arch} one prefill batch ({ZOO_REQUESTS} x {prompt}"
            f"{f' + {prefix} patches' if prefix else ''}"
            f"{f' + {WHISPER_FRAMES} frames' if cfg.family == 'encdec' else ''})",
            wall, kernel_ms, ours, smi)
        step = {"tokens": lg.argmax(-1)[:, None]}

        def decode_once():
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, step,
                                     prefix + prompt)
        (lg, _), wall, kernel_ms, ours = profiled(decode_once)
        finite(arch, "decode", lg)
        info["decode_profile"] = _report(
            "7b", f"{arch} one decode step ({ZOO_REQUESTS} rows)", wall,
            kernel_ms, ours, smi)
        del cache

        if arch == "qwen2_0_5b":
            info["int8"] = _zoo_int8_gate(params, cfg, batch, smi)

        # the card against the CPU on one row, depth cut, float32
        cut, cut_cfg = _cut_depth(params, cfg)
        one = {k: v[:1] for k, v in batch.items()}
        tok = rng.integers(0, cfg.vocab_size, (1, CPU_DECODE_STEPS))
        got = {}
        for dev, p in ((DEVICE, cut), ("cpu", tree.to_device(cut, "cpu"))):
            t0 = time.time()
            with torch.no_grad():
                lg, cache = T.prefill(p, cut_cfg, one, max_len=max_len)
                logits = [lg]
                for j in range(CPU_DECODE_STEPS):
                    lg, cache = T.decode_step(p, cut_cfg, cache,
                                              {"tokens": tok[:, j:j + 1]},
                                              prefix + prompt + j)
                    logits.append(lg)
            got[dev] = torch.stack(logits).float().cpu()
            log(f"[7b] {arch} depth 1 float32 prefill + {CPU_DECODE_STEPS} "
                f"decode steps on {dev}: {time.time() - t0:.1f} s")
        err, _ = _rel_err(got[DEVICE], got["cpu"])
        rel = err / float(got["cpu"].abs().max())
        log(f"[7b] {arch} card vs CPU: max err {err:.3g} ({rel:.3g} of max "
            f"|CPU|, limit {TOL})")
        if not rel <= TOL:
            fail(f"{arch}: card and CPU logits differ by {err} ({rel} of "
                 f"max |CPU|, limit {TOL})")
        info["card_vs_cpu_max_err"] = err
        results[arch] = info
        del params, cut, got, lg, cache
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[7b] {arch} phase: {time.time() - t_arch:.1f} s")
    results["launches"] = sum(r["launches"]["flash_attn"]
                              for r in results.values())
    return results


def _zoo_int8_gate(params, cfg, batch, smi) -> dict:
    """qwen2_0_5b with an int8 KV cache on the card: prefill on the 4 x
    512 prompts, then ZOO_INT8_STEPS teacher-forced decode steps, each
    step's logits against the bf16 config's teacher-forced ones (the
    JAX package's gate: correlation > 0.99, max |diff| < 0.2); the cache
    must be int8 with its scales."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    rng = np.random.default_rng(1)
    tok = np.concatenate([batch["tokens"], rng.integers(
        0, cfg.vocab_size, (ZOO_REQUESTS, ZOO_INT8_STEPS))], axis=1)
    with torch.no_grad():
        t0 = time.time()
        _, cache = T.prefill(params, cfg8, {"tokens": tok[:, :ZOO_PROMPT]},
                             max_len=ZOO_PROMPT + ZOO_NEW)
        if cache["k"].dtype != torch.int8 or "ks" not in cache:
            fail(f"int8 KV: cache {cache['k'].dtype}, keys {sorted(cache)}")
        steps = []
        for j in range(ZOO_INT8_STEPS):
            pos = ZOO_PROMPT + j
            lg, cache = T.decode_step(params, cfg8, cache,
                                      {"tokens": tok[:, pos:pos + 1]}, pos)
            steps.append(lg.float())
        torch.cuda.synchronize()
        wall = time.time() - t0
        tf, _ = T.forward_logits(params, cfg, {"tokens": tok})
    info = {"wall_s": wall, "corr": [], "max_abs_diff": []}
    for j, lg in enumerate(steps):
        want = tf[:, ZOO_PROMPT + j].float()
        corr = float(torch.corrcoef(torch.stack([lg.ravel(),
                                                 want.ravel()]))[0, 1])
        diff = float((lg - want).abs().max())
        info["corr"].append(corr)
        info["max_abs_diff"].append(diff)
        if not (corr > 0.99 and diff < 0.2):
            fail(f"int8 KV decode step {j}: correlation {corr}, max |diff| "
                 f"{diff} against the bf16 teacher-forced logits (gate "
                 "> 0.99, < 0.2)")
    info["cache_bytes"] = sum(cache[k].numel() * cache[k].element_size()
                              for k in cache)
    log(f"[7b] qwen2_0_5b int8 KV prefill + {ZOO_INT8_STEPS} decode steps "
        f"({smi}): " + json.dumps(info))
    return info


# ---------------------------------------------------------------------------
# phase 8: the paper's pipeline from run_selection down
# ---------------------------------------------------------------------------

SEL_POOL, SEL_SEED_OFFSET = 64, 8
CPU_STEPS, CPU_BATCH = 3, 8        # the card-vs-CPU training check
# cuts of SelectionConfig's step counts (finetune 200, ex-vivo 300,
# in-vivo 150). 8a: ex-vivo to 100, for time (its two runs took 120-167
# s at 300, PERF.md). 8b: also finetune and in-vivo to 3, below the
# random target's divergence
A_STEPS = {"exvivo_steps": 100}
CUT_STEPS = {**A_STEPS, "finetune_steps": CPU_STEPS,
             "invivo_steps": CPU_STEPS}
# the CPU tests' tolerances (tests/test_torch_training.py): per-step
# losses 1e-5, parameters 1e-4 absolute. Exempt from the 1e-4, and held
# within steps x lr (the most Adam's updates can move one), are only M_g's
# elements whose first gradient on the CPU is nonzero and below Adam's
# eps: there the first update g / (|g| + eps) follows the gradient's
# float32 rounding
LOSS_ATOL, PARAM_ATOL, ADAM_EPS = 1e-5, 1e-4, 1e-8
FINETUNE_LR, INVIVO_LR = 1e-3, 5e-4     # target.finetune, invivo_finetune
COUNTERS = ("fa", "fa_bwd", "msa", "msa_bwd", "eh", "rmm", "smm")


def _counters() -> dict:
    from repro_torch.kernels import ops as kops
    return {name: getattr(kops, f"{name}_stats")() for name in COUNTERS}


def _reset_counters() -> None:
    from repro_torch.kernels import ops as kops
    for name in COUNTERS:
        getattr(kops, f"reset_{name}_stats")()


def _delta(after: dict, before: dict) -> dict:
    return {n: {k: after[n][k] - before[n].get(k, 0) for k in after[n]}
            for n in after}


class _LossLog:
    """Records every training loss while it is open: wraps
    `models.common.cross_entropy`, the loss `target.finetune` and
    `proxy.invivo_finetune` take a step on (restored on exit); `values`
    holds them as floats after exit."""

    def __enter__(self):
        from repro_torch.models import common
        self._fn, self._raw = common.cross_entropy, []

        def logged(*a, **kw):
            loss = self._fn(*a, **kw)
            self._raw.append(loss.detach())
            return loss
        common.cross_entropy = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import common
        common.cross_entropy = self._fn
        self.values = [float(x) for x in self._raw]


class _FirstGrad:
    """Records M_g's first training gradient while it is open: wraps the
    `grads` that `target.finetune` takes its steps on (restored on exit);
    `first` holds the first step's gradients on the CPU."""

    def __enter__(self):
        from repro_torch.core import target
        self._fn, self.first = target.grads, None

        def logged(loss, leaves):
            g = self._fn(loss, leaves)
            if self.first is None:
                self.first = [x.detach().cpu() for x in g]
            return g
        target.grads = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.core import target
        target.grads = self._fn


class _Stages:
    """Wraps the pipeline's stage functions for one run (restored on
    exit): each call's wall (ending in a synchronize), the launch-counter
    delta over it, the training stages' per-step losses, and the trained
    proxies (in-vivo's outputs, in phase order)."""

    def __init__(self):
        self.log: list[dict] = []
        self.proxies: list = []
        self._orig: list = []

    def __enter__(self):
        from repro_torch.core import executor, proxy, selection, target
        from repro_torch.mpc import quickselect
        for mod, name, stage, losses in (
                (target, "finetune", "M_g finetune", True),
                (proxy, "collect_stats", "stats", False),
                (proxy, "build_proxy", "ex-vivo fits", False),
                (proxy, "invivo_finetune", "in-vivo", True),
                (selection, "_score_clear", "sieve (clear scoring)", False),
                (executor.WaveExecutor, "score_phase",
                 "sieve (MPC scoring)", False),
                (quickselect, "top_k_indices", "sieve (QuickSelect)",
                 False)):
            self._wrap(mod, name, stage, losses)
        return self

    def _wrap(self, mod, name, stage, losses):
        import torch
        fn = getattr(mod, name)
        self._orig.append((mod, name, fn))

        def timed(*a, **kw):
            torch.cuda.synchronize()
            before, t0 = _counters(), time.time()
            with _LossLog() as ll:
                out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec = {"stage": stage, "wall_s": time.time() - t0,
                   "launches": _delta(_counters(), before)}
            if losses:
                rec["losses"] = ll.values
            if stage == "in-vivo":
                self.proxies.append(out)
            self.log.append(rec)
            return out
        setattr(mod, name, timed)

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._orig):
            setattr(mod, name, fn)


def _sel_config(mode, ckpt, ring=None, steps=None):
    """Phase 8's SelectionConfig: `two_phase_default(12)`, phase 3's
    executor flags, SelectionConfig's step counts unless `steps` cuts
    them."""
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import selection
    from repro_torch.core.executor import ExecConfig
    exe = ExecConfig(wave=WAVE, coalesce=True, overlap=True, fuse=True,
                     batch=BATCH, device=DEVICE,
                     **({"ring": ring} if ring else {}))
    return selection.SelectionConfig(
        selection.two_phase_default(BERT.n_heads), mode=mode,
        score_batch=BATCH, checkpoint_dir=ckpt, executor=exe,
        **(steps or {}))


def _run_selection(seed, params, pool, labels, mode, ckpt, ring=None,
                   steps=None):
    """run_selection on the card at the phase's scale, SelectionConfig's
    step counts unless `steps` cuts them (printed); returns (result,
    stage log, trained proxies, wall s, counters)."""
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import selection
    from repro_torch.mpc import prng
    sel = _sel_config(mode, ckpt, ring, steps)
    if steps:
        log(f"[8] {mode}: step counts cut from SelectionConfig's defaults "
            f"to {steps}")
    _reset_counters()
    with _Stages() as st:
        t0 = time.time()
        res = selection.run_selection(
            prng.key(seed, device=DEVICE), params, BERT, pool, sel,
            n_classes=CLASSES, boot_labels_fn=lambda i: labels[i])
        torch.cuda.synchronize()
        wall = time.time() - t0
    return res, st.log, st.proxies, wall, _counters()


def _gate_run(tag, res, stages, counts, scoring, held: int) -> None:
    """Fatal unless each training stage launched its backward kernel,
    the scoring the kernels named in `scoring`, nothing took a plain
    version, M_g's finetune losses and those of the first `held` phases'
    in-vivo finetunes are finite, and (`held` covering every phase) the
    appraisal is finite."""
    import math
    plain = {n: c["ref"] for n, c in counts.items() if c["ref"]}
    if plain:
        fail(f"{tag}: plain versions ran on the card: {plain}")
    need = {"M_g finetune": ("fa_bwd", "fa"), "in-vivo": ("msa_bwd", "msa"),
            "stats": ("fa",), "ex-vivo fits": ("eh",)}
    for rec in stages:
        for name in need.get(rec["stage"], ()):
            if rec["launches"][name]["kernel"] <= 0:
                fail(f"{tag}: {rec['stage']} launched no {name} kernel "
                     f"({rec['launches'][name]})")
            # a backward call launches two kernels, each counted
            if name.endswith("_bwd") and rec["launches"][name]["kernel"] % 2:
                fail(f"{tag}: {rec['stage']} counted an odd number of "
                     f"{name} launches ({rec['launches'][name]})")
    for name in scoring:
        if counts[name]["kernel"] <= 0:
            fail(f"{tag}: the sieve launched no {name} kernel")
    invivo = [r for r in stages if r["stage"] == "in-vivo"]
    for rec in [r for r in stages if r["stage"] == "M_g finetune"] \
            + invivo[:held]:
        if not all(map(math.isfinite, rec["losses"])):
            fail(f"{tag}: {rec['stage']} losses not finite "
                 f"({rec['losses'][:3]} ... {rec['losses'][-1]})")
    if len(res.phase_survivors) != 2 or len(res.selected) != round(
            0.2 * SEL_POOL):
        fail(f"{tag}: {len(res.selected)} selected, "
             f"{len(res.phase_survivors)} phases")
    if held >= len(invivo) and not math.isfinite(res.appraisal_entropy):
        fail(f"{tag}: appraisal {res.appraisal_entropy}")


def _log_run(tag, res, stages, wall, counts) -> dict:
    info = {"wall_s": wall, "boot_idx": res.boot_idx.tolist(),
            "survivors": [s.tolist() for s in res.phase_survivors],
            "selected": res.selected.tolist(),
            "appraisal": res.appraisal_entropy,
            "resumed_phases": res.resumed_phases,
            "launches": counts, "stages": []}
    for rec in stages:
        item = {"stage": rec["stage"], "wall_s": rec["wall_s"],
                "launches": {n: c["kernel"] for n, c in rec["launches"]
                             .items() if c["kernel"]}}
        if "losses" in rec:
            ls = rec["losses"]
            item.update(steps=len(ls), first_loss=ls[0] if ls else None,
                        last_loss=ls[-1] if ls else None)
        info["stages"].append(item)
        log(f"[8] {tag} {item['stage']}: {item['wall_s']:.2f} s, "
            + (f"{item['steps']} steps, loss {item['first_loss']:.5f} -> "
               f"{item['last_loss']:.5f}, " if "losses" in rec and
               rec["losses"] else "")
            + f"launches {item['launches']}")
    for r in res.exec_reports:
        log(f"[8] {tag} executor phase: agrees {r.agrees()}, rounds "
            f"{r.ledger.rounds}, wall {r.wall_s:.2f} s, device makespan "
            f"{r.device_makespan_s:.2f} s")
    log(f"[8] {tag}: {wall:.1f} s; boot {info['boot_idx']}; survivors "
        f"{info['survivors']}; appraisal {res.appraisal_entropy:.6f}; "
        f"launches {counts}")
    return info


def _scored(res) -> list:
    """The candidates each sieve phase of `res` scored (pool rows)."""
    import numpy as np
    return [np.setdiff1d(np.arange(SEL_POOL), res.boot_idx),
            res.phase_survivors[0]]


def _mpc_vs_clear(cands, recon, proxies, pool, ring) -> tuple[list, list]:
    """Largest |decoded MPC - clear| entropy per phase: `recon` holds each
    phase's reconstructed ring scores of `cands`, the trained proxies
    score the same candidates in the clear; and the count of non-finite
    clear scores per phase."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.selection import _score_clear, two_phase_default
    from repro_torch.engine import ClearEngine
    errs, bad = [], []
    for pi, (spec, pp) in enumerate(zip(two_phase_default(BERT.n_heads),
                                        proxies)):
        clear = _score_clear(ClearEngine(), pp, BERT, pool[cands[pi]], spec,
                             batch=BATCH)
        mpc = torch.as_tensor(recon[pi]).double() / ring.scale
        errs.append(float(np.abs(mpc.numpy() - clear).max()))
        bad.append(int((~np.isfinite(clear)).sum()))
    return errs, bad


def _rescore_ring64(seed, mres, proxies, pool) -> list:
    """8b's trained proxies scored again on RING64 (the same candidates
    as the RING32 run's phases): the decoded scores against the clear
    ones, so RING32's error can be told from the fixed point's."""
    import numpy as np
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.core.selection import two_phase_default
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING64
    from repro_torch.mpc.sharing import reconstruct
    cands = _scored(mres)
    _reset_counters()
    scores = []
    for pi, (spec, pp) in enumerate(zip(two_phase_default(BERT.n_heads),
                                        proxies)):
        ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=RING64,
                                     device=DEVICE))
        ent = ex.score_phase(prng.key(seed + 40 + pi, device=DEVICE), pp,
                             BERT, pool[cands[pi]], spec)
        scores.append(reconstruct(ent).cpu())
    counts = _counters()
    if counts["rmm"]["kernel"] <= 0 or any(c["ref"] for c in
                                           counts.values()):
        fail(f"8b ring64: launches {counts}")
    errs, bad = _mpc_vs_clear(cands, scores, proxies, pool, RING64)
    log(f"[8] 8b ring64, the same trained proxies and candidates: max "
        f"|decoded MPC - clear| entropy per phase {errs}")
    if any(bad) or not all(np.isfinite(errs)):
        fail(f"8b ring64: errors {errs}")
    return errs


def _card_vs_cpu_training(seed, params, pool, labels, boot_idx) -> dict:
    """M_g's finetune and one build_proxy + invivo_finetune (spec
    <1,12,16>) at BERT-base width, depth cut to 1, CPU_STEPS steps of
    batch CPU_BATCH, on the card and on the CPU from the same weights:
    the bootstrap draw and batch indices bitwise, per-step losses and
    parameters within the CPU tests' tolerances; M_g's elements whose
    first gradient on the CPU is nonzero and below ADAM_EPS are held
    within steps x lr instead."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import proxy, target, tree
    from repro_torch.core.proxy import ProxySpec
    from repro_torch.models.transformer import layer_slice
    from repro_torch.mpc import prng
    draws = {}
    for dev in (DEVICE, "cpu"):
        k = prng.key(seed, device=dev)
        rng = np.random.default_rng(int(prng.randint(k, (), 0, 2 ** 31 - 1)))
        boot = np.sort(rng.choice(SEL_POOL, size=len(boot_idx),
                                  replace=False))
        k, idx = prng.key(seed + 1, device=dev), []
        for _ in range(CPU_STEPS):         # finetune's draws, in its order
            k, kk = prng.split(k).unbind(-2)
            idx.append(prng.randint(kk, (CPU_BATCH,), 0, len(boot_idx))
                       .cpu())
        draws[dev] = (boot, idx)
    if not (np.array_equal(draws[DEVICE][0], draws["cpu"][0])
            and np.array_equal(draws[DEVICE][0], boot_idx)
            and all(torch.equal(a, b) for a, b in
                    zip(draws[DEVICE][1], draws["cpu"][1]))):
        fail(f"card vs CPU: bootstrap or batch indices differ ({draws})")
    cut = {k: (layer_slice(v, slice(0, 1)) if k == "layers" else v)
           for k, v in params.items() if k != "unembed"}
    tok, lab = pool[boot_idx], labels[boot_idx]
    spec = ProxySpec(1, BERT.n_heads, 16)
    out, walls, glog = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        p = tree.to_device(cut, dev)
        t0 = time.time()
        with _LossLog() as fl, _FirstGrad() as fg:
            mg, _ = target.finetune(prng.key(seed + 1), p, BERT, tok, lab,
                                    steps=CPU_STEPS, batch=CPU_BATCH,
                                    n_layers=1)
        tuned = tree.tree_leaves(tree.to_device(mg, "cpu"))
        if dev == DEVICE:          # both build the proxy from one M_g
            mg_start = tree.to_device(mg, "cpu")
        mg = tree.to_device(mg_start, dev)
        stats = proxy.collect_stats(mg, BERT, tok, spec)
        pp = proxy.build_proxy(prng.key(seed + 2), mg, BERT, stats, spec,
                               seq_len=SEQ, n_classes=CLASSES,
                               exvivo_steps=CPU_STEPS)
        with _LossLog() as il:
            pp = proxy.invivo_finetune(prng.key(seed + 3), pp, BERT, tok,
                                       lab, spec, steps=CPU_STEPS,
                                       batch=CPU_BATCH)
        if dev == DEVICE:
            torch.cuda.synchronize()
        walls[dev] = time.time() - t0
        out[dev] = (fl.values, tuned, il.values,
                    tree.tree_leaves(tree.to_device(pp, "cpu")))
        glog[dev] = fg
    res = {"walls_s": walls}
    for i, what in enumerate(("finetune losses", "finetune params",
                              "in-vivo losses", "proxy params")):
        a, b = out[DEVICE][i], out["cpu"][i]
        if "losses" in what:
            err = max(abs(x - y) for x, y in zip(a, b))
            res[what] = err
            log(f"[8] card vs CPU (depth 1, {CPU_STEPS} steps, batch "
                f"{CPU_BATCH}) {what}: max err {err:.3g} (limit "
                f"{LOSS_ATOL})")
            if not err <= LOSS_ATOL:
                fail(f"card vs CPU: {what} differ by {err}")
            continue
        diff = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
        over = diff > PARAM_ATOL
        bound = CPU_STEPS * (FINETUNE_LR if "finetune" in what
                             else INVIVO_LR)
        res[what] = {"max_err": float(diff.max()), "over": int(over.sum()),
                     "elements": diff.numel()}
        exempt = torch.zeros_like(over)
        if "finetune" in what:     # M_g's first gradients, on both sides
            card_g, cpu_g = glog[DEVICE], glog["cpu"]
            g1 = torch.cat([x.flatten() for x in cpu_g.first]).abs()
            exempt = (g1 > 0) & (g1 < ADAM_EPS)
            res[what].update(
                exempt=int(exempt.sum()),
                abs_first_grad_where_over=[
                    float(x) for x in g1[over].sort().values[:8]],
                first_grad_max_rel_diff=max(
                    float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                    for x, y in zip(card_g.first, cpu_g.first)))
        held = float(diff[~exempt].max()) if (~exempt).any() else 0.0
        res[what]["max_err_held"] = held
        log(f"[8] card vs CPU (depth 1, {CPU_STEPS} steps, batch "
            f"{CPU_BATCH}) {what}: max err {float(diff.max()):.3g}; "
            f"{int(exempt.sum())} of {diff.numel()} elements with a first "
            f"gradient in (0, {ADAM_EPS}) on the CPU, the rest within "
            f"{held:.3g} (limit {PARAM_ATOL}); {int(over.sum())} over "
            f"{PARAM_ATOL} (each within {bound:.3g})"
            + (f", first |g| there {res[what]['abs_first_grad_where_over']}"
               f"; first gradient card vs CPU within "
               f"{res[what]['first_grad_max_rel_diff']:.3g} of max |g| "
               f"(leaf by leaf)" if "finetune" in what else ""))
        if not held <= PARAM_ATOL or not float(diff.max()) <= bound:
            fail(f"card vs CPU: {what}: max err {held} outside the "
                 f"elements whose gradient fell below {ADAM_EPS}, "
                 f"max {float(diff.max())}")
    res["finetune_losses"] = {d: out[d][0] for d in out}
    res["invivo_losses"] = {d: out[d][2] for d in out}
    log(f"[8] card vs CPU: walls {walls}; losses card "
        f"{res['finetune_losses'][DEVICE]} / {res['invivo_losses'][DEVICE]}")
    return res


def phase_selection(seed: int, smi: str) -> dict:
    """The paper's pipeline on the card from `run_selection` down: a
    BERT-base target at full depth and width (random, from --seed), a
    pool of 64 at seq 512 (8 bootstrap rows, a budget of 13),
    `two_phase_default(12)`:
      8a  SelectionConfig's step counts (ex-vivo cut to 100 for time),
          mode="clear" then mode="mpc" on
          RING32 with phase 3's executor flags. M_g's finetune and
          phase 1's proxy are held finite. From this random target the
          phase-2 proxy out of the ex-vivo fits is non-finite (the JAX
          package's is too at this width: PERF.md,
          tools/selection_divergence.py), so phase 2's scores are
          reported, not held finite;
      8b  the same with M_g's finetune and the in-vivo finetune cut to
          CUT_STEPS, below the divergence: finite scores, and the
          decoded MPC scores against the clear ones per phase, on
          RING32, and the same proxies rescored on RING64 (the fixed
          point's share of that error);
      8c  the card against the CPU on the training steps;
      8d  8a's clear run resumed from its phase checkpoints."""
    import math
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import target
    from repro_torch.data.tasks import make_classification_task
    from repro_torch.mpc.ring import RING32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = make_classification_task(seed + SEL_SEED_OFFSET,
                                    n_pool=SEL_POOL, n_test=8, seq=SEQ,
                                    vocab=BERT.vocab_size, n_classes=CLASSES)
    pool, labels = task.pool_tokens, task.pool_labels
    params = target.init_classifier(
        torch.Generator(device=DEVICE).manual_seed(seed + SEL_SEED_OFFSET),
        BERT, CLASSES, device=DEVICE)
    out = {}

    def both_modes(tag, steps, ckpt, held):
        res, stages, _, wall, counts = _run_selection(
            seed, params, pool, labels, "clear", ckpt, steps=steps)
        out[f"{tag} clear"] = _log_run(f"{tag} clear", res, stages, wall,
                                       counts)
        _gate_run(f"{tag} clear", res, stages, counts, ("msa",), held)
        name = f"{tag} mpc ring32"
        mres, mstages, proxies, mwall, mcounts = _run_selection(
            seed, params, pool, labels, "mpc", None, RING32, steps)
        out[name] = _log_run(name, mres, mstages, mwall, mcounts)
        _gate_run(name, mres, mstages, mcounts, ("rmm", "smm"), held)
        if not all(r.agrees() for r in mres.exec_reports):
            fail(f"{name}: a phase ledger does not agree")
        errs, bad = _mpc_vs_clear(
            _scored(mres), [torch.as_tensor(x).sum(0)
                            for x in mres.phase_scores], proxies, pool,
            RING32)
        out[name].update(max_abs_mpc_minus_clear=errs,
                         nonfinite_clear_scores=bad)
        log(f"[8] {name}, trained proxies: max |decoded MPC - clear| "
            f"entropy per phase {errs}; non-finite clear scores per phase "
            f"{bad}")
        if any(bad[:held]) or not all(map(math.isfinite, errs[:held])):
            fail(f"{name}: non-finite scores {bad}, errors {errs}")
        log(f"[8] {tag} ({smi}): clear {wall:.1f} s, mpc {mwall:.1f} s, "
            f"together {wall + mwall:.1f} s; the two share "
            f"{len(set(res.selected) & set(mres.selected))} of "
            f"{len(res.selected)} selected")
        return res, counts, mcounts, mres, proxies

    with tempfile.TemporaryDirectory() as ckpt:
        res, counts, mcounts, _, _ = both_modes("8a", A_STEPS, ckpt,
                                                held=1)
        _, _, _, mres_b, proxies_b = both_modes("8b", CUT_STEPS, None,
                                                held=2)
        out["8b ring64"] = _rescore_ring64(seed, mres_b, proxies_b, pool)
        out["card_vs_cpu"] = _card_vs_cpu_training(seed, params, pool,
                                                    labels, res.boot_idx)
        rres, rstages, _, rwall, rcounts = _run_selection(
            seed, params, pool, labels, "clear", ckpt, steps=A_STEPS)
        out["resume"] = _log_run("8d resumed clear", rres, rstages, rwall,
                                 rcounts)
        same = np.array_equal(rres.appraisal_entropy, res.appraisal_entropy,
                              equal_nan=True)
        if rres.resumed_phases != 2 or not same or any(
                not np.array_equal(a, b) for a, b in
                zip(rres.phase_survivors, res.phase_survivors)):
            fail(f"resume: {rres.resumed_phases} phases resumed, appraisal "
                 f"{rres.appraisal_entropy} against "
                 f"{res.appraisal_entropy}")
    # 8a's two runs (clear, then MPC): the training's kernels, forward
    # and backward, and the sieve's
    out["launches"] = {n: mcounts[n]["kernel"] + counts[n]["kernel"]
                       for n in COUNTERS}
    # what phase 10 serves again: the target, the pool, 8b's MPC result
    out["inputs"] = (params, pool, labels)
    out["8b mpc result"] = mres_b
    return out


# ---------------------------------------------------------------------------
# phase 9: the exact-op MPC baselines, the analytic mirror, the launcher
# ---------------------------------------------------------------------------

EXACT = ("no-sm", "no-ln", "no-se", "quad_sm", "poly_sm")
# 9a's pool: one wave of 2 batches of BATCH, cut from WAVE batches (183 s
# for the twelve runs), never the width; the walls are host-bound, so
# the cut saved less than half (PERF.md §5)
VAR_BATCHES = 2
# 9a's depth: phase 3's phase-2 proxy cut from 3 layers to 1 at the same
# width, to pay for phase 11 (9a took 144-151 s at depth 3, PERF.md §5)
VAR_LAYERS = 1
VAR_SEQ = 128                  # 9b's cut sequence (one row, depth 1)
# 9b's rows: each exact-op variant on one ring, the rings alternating
# (cut from both rings for time when phase 12 came, PERF.md §6; the ring
# kernels are held bitwise on both rings in phase 2)
VAR_CPU_RING = {"no-sm": 32, "no-ln": 64, "no-se": 32, "quad_sm": 64,
                "poly_sm": 32}
SELECT_POOL, SELECT_BUDGET = 800, 0.2      # launch/select.run's defaults


def _plain(counts) -> dict:
    return {n: c["ref"] for n, c in counts.items() if c["ref"]}


def _cut_proxy(spec, pp, n_layers: int):
    """A proxy's first `n_layers` layers at the same width (embedding,
    class head and MLP_se kept): the depth cut of a later path."""
    from repro_torch.core.proxy import ProxySpec
    out = dict(pp, attn={k: v[:n_layers] for k, v in pp["attn"].items()})
    for k in ("ln_scale", "ln_bias", "mlp_sm", "mlp_ln"):
        out[k] = pp[k][:n_layers]
    return ProxySpec(n_layers, spec.n_heads, spec.mlp_dim,
                     spec.selectivity), out


def _mirror_stream(led) -> list:
    """What the probe and the mirror share (the mirror names its sites)."""
    return [(r.rounds, r.nbytes, r.numel, r.flops, r.tag)
            for r in led.records]


def _on(tree, dev):
    """A tree of shares with every share's components moved to `dev`."""
    from repro_torch.core.tree import tree_leaves, tree_rebuild
    return tree_rebuild(tree, [s.with_sh(s.sh.to(dev))
                               for s in tree_leaves(tree)])


def phase_variants(seed: int, proxies, smi: str) -> dict:
    """9a: Table 2's ablations and Table 3's baselines executed over
    shares at BERT-base width: phase 3's phase-2 proxy cut to VAR_LAYERS
    layers (<1,12,16>) and phase 3's executor flags over one wave
    (VAR_BATCHES batches of BATCH), each
    variant beside the full one, on RING32 then RING64. Fatal unless each phase
    agrees with its schedule, launches its ring kernel (secure_matmul on
    RING32, ring_matmul on RING64), runs no plain version and scores
    finite; decoded scores against ClearEngine with the same variant
    are printed (RING32's 12 fractional bits may wrap in exp and the NR
    reciprocal, so they are not gated)."""
    import numpy as np
    import torch
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.engine import VARIANTS, ClearEngine, proxy_entropy
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.mpc.sharing import reconstruct
    cfg, specs, pps = proxies
    spec, pp = _cut_proxy(specs[1], pps[1], VAR_LAYERS)
    pool = np.random.default_rng(seed + 9).integers(
        0, cfg.vocab_size, (VAR_BATCHES * BATCH, SEQ))
    tok = torch.as_tensor(pool, device=DEVICE)
    clear, out = {}, {}
    launches = {"ring_matmul": 0, "secure_matmul": 0}
    for ring in (RING32, RING64):
        for name in ("full",) + EXACT:
            variant = VARIANTS[name]
            tag = f"{ring.name} {name}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            ex = WaveExecutor(ExecConfig(wave=WAVE, coalesce=True,
                                         overlap=True, fuse=True,
                                         batch=BATCH, ring=ring,
                                         device=DEVICE))
            t0 = time.time()
            ent = ex.score_phase(prng.key(seed + 90, device=DEVICE), pp, cfg,
                                 pool, spec, variant)
            vals = ring.decode(reconstruct(ent)).double()
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = _counters()
            rep = ex.reports[-1]
            ring_kernel = "smm" if ring.bits == 32 else "rmm"
            if not rep.agrees():
                fail(f"9a {tag}: ledger does not agree with the schedule")
            if counts[ring_kernel]["kernel"] <= 0:
                fail(f"9a {tag}: {ring_kernel} not launched ({counts})")
            if _plain(counts):
                fail(f"9a {tag}: a plain version ran ({_plain(counts)})")
            if vals.shape != (len(pool),) or not torch.isfinite(vals).all():
                fail(f"9a {tag}: scores of shape {tuple(vals.shape)} or "
                     "not finite")
            launches["ring_matmul"] += counts["rmm"]["kernel"]
            launches["secure_matmul"] += counts["smm"]["kernel"]
            if name not in clear:
                clear[name] = torch.cat([
                    proxy_entropy(ClearEngine(), pp, cfg, tok[i:i + BATCH],
                                  spec, variant)
                    for i in range(0, len(tok), BATCH)]).double()
            led = rep.ledger
            info = {"wall_s": wall,
                    "device_makespan_s": rep.device_makespan_s,
                    "rounds": led.rounds, "lat_rounds": led.lat_rounds,
                    "bw_rounds": led.bw_rounds, "nbytes": led.nbytes,
                    "offline_nbytes": led.offline_nbytes,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "max_abs_mpc_minus_clear": float(
                        (vals - clear[name]).abs().max()),
                    "ring_matmul": counts["rmm"]["kernel"],
                    "secure_matmul": counts["smm"]["kernel"]}
            log(f"[9a] {tag} <{spec.n_layers},{spec.n_heads},"
                f"{spec.mlp_dim}>, {len(pool)} candidates ({smi}): "
                + json.dumps(info))
            out[tag] = info
    out["launches"] = launches
    return out


def phase_variants_card_vs_cpu(seed: int) -> None:
    """9b: each exact-op variant's forward on the card and on the CPU
    with the same keys, one row at depth CPU_LAYERS and seq VAR_SEQ (a
    proxy of that seq, random from --seed; widths stay BERT-base's), on
    its ring of VAR_CPU_RING: shares bitwise equal. The cuts bound the
    CPU's time; the ring kernels are held bitwise at the path's shapes
    in phase 2."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.proxy import ProxySpec, random_proxy, share_proxy
    from repro_torch.engine import VARIANTS, MPCEngine, proxy_entropy
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.mpc.sharing import Share, share
    spec = ProxySpec(CPU_LAYERS, *PHASES[1][1:])
    pp = random_proxy(torch.Generator().manual_seed(seed + 91), BERT, spec,
                      VAR_SEQ, CLASSES, device="cpu")
    emb = pp.pop("embed")
    tok = np.random.default_rng(seed + 92).integers(0, BERT.vocab_size,
                                                    (1, VAR_SEQ))
    x = emb[torch.as_tensor(tok)] * float(np.float32(BERT.d_model ** 0.5))
    for ring in (RING32, RING64):
        key = prng.key(seed + 93)
        pp_sh = share_proxy(prng.fold_in(key, 1), pp, ring)
        x_sh = share(prng.fold_in(key, 2), x, ring)
        for name in (n for n in EXACT if VAR_CPU_RING[n] == ring.bits):
            got = {}
            for dev in (DEVICE, "cpu"):
                d = torch.device(dev)
                psh = _on(pp_sh, d)
                eng = MPCEngine(ring).with_key(prng.fold_in(key, 3).to(d))
                t0 = time.time()
                ent = proxy_entropy(eng, psh, BERT, Share(x_sh.sh.to(d),
                                                          ring),
                                    spec, VARIANTS[name])
                got[dev] = (ent.sh.cpu(), time.time() - t0)
            if not torch.equal(got[DEVICE][0], got["cpu"][0]):
                fail(f"9b {ring.name} {name}: card and CPU shares differ")
            log(f"[9b] {ring.name} {name}: card == CPU, bitwise (card "
                f"{got[DEVICE][1]:.2f} s, CPU {got['cpu'][1]:.2f} s)")


def phase_mirror(proxies) -> dict:
    """9c: `costs.proxy_exec_cost` against the meta probe of the executed
    forward, record for record (rounds, bytes, numel, flops, tag), for
    phase 3's two proxies at its batch, eager and fused, on both rings;
    then `schedule_search.grid_search(42_000)`'s Pareto frontier."""
    from repro_torch.core import schedule_search
    from repro_torch.engine import cached_probe
    from repro_torch.mpc import costs
    from repro_torch.mpc.ring import RING32, RING64
    cfg, specs, _ = proxies
    for ring in (RING32, RING64):
        for spec in specs:
            for fused in (False, True):
                probe = cached_probe(cfg, spec, batch=BATCH, seq=SEQ,
                                     classes=CLASSES, ring=ring, fused=fused)
                mirror = costs.proxy_exec_cost(
                    BATCH, SEQ, cfg.d_model, spec.n_heads, cfg.n_kv_heads,
                    cfg.d_head, spec.mlp_dim, CLASSES, spec.n_layers,
                    ring=ring, fused=fused)
                name = (f"{ring.name} <{spec.n_layers},{spec.n_heads},"
                        f"{spec.mlp_dim}> {'fused' if fused else 'eager'}")
                if _mirror_stream(probe) != _mirror_stream(mirror):
                    fail(f"9c {name}: the mirror differs from the probe")
                log(f"[9c] {name}: mirror == probe, {len(probe.records)} "
                    f"records, {probe.rounds} rounds, {probe.nbytes} online "
                    f"B, {probe.offline_nbytes} offline B")
    t0 = time.time()
    front = schedule_search.grid_search(42_000)
    out = [{"phases": [[p.n_layers, p.n_heads, p.mlp_dim, p.selectivity]
                       for p in s.phases],
            "delay_wan_h": s.delay_s / 3600, "capacity": s.capacity}
           for s in front]
    log(f"[9c] grid_search(42000) Pareto frontier ({time.time() - t0:.1f} "
        "s): " + json.dumps(out))
    return {"frontier": out}


def phase_select(seed: int, smi: str) -> dict:
    """9d: the launcher, `launch.select.run(mode="mpc", ring_bits=32,
    resume=False)` at its defaults on the card. Fatal unless the phase
    ledgers agree, the purchase is the budget, secure_matmul and every
    clear-side kernel (flash_attn forward and backward in the finetunes,
    mlp_softmax_attn forward and backward in in-vivo, entropy_head in
    the fits) launched, and no plain version ran."""
    import torch
    from repro_torch.launch import select
    _reset_counters()
    t0 = time.time()
    out = select.run(seed, mode="mpc", ring_bits=32, resume=False,
                     device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _counters()
    ex = out["executed"]
    if ex["ledger_agrees"] is not True:
        fail(f"9d: ledger_agrees {ex['ledger_agrees']}")
    if out["n_selected"] != int(SELECT_BUDGET * SELECT_POOL):
        fail(f"9d: {out['n_selected']} selected")
    missing = [n for n in ("smm", "fa", "fa_bwd", "msa", "msa_bwd", "eh")
               if counts[n]["kernel"] <= 0]
    if missing or _plain(counts):
        fail(f"9d: not launched {missing}, plain {_plain(counts)}")
    d = out["paper_scale_delay"]
    info = {"wall_s": wall, "acc_ours": out["acc_ours"],
            "acc_random": out["acc_random"],
            "selection_wall_s": out["selection_wall_s"],
            "device_makespan_s": [p["device_makespan_s"]
                                  for p in ex["phases"]],
            "paper_scale_delay": d,
            "launches": {n: c["kernel"] for n, c in counts.items()}}
    log(f"[9d] launch.select.run mpc ring32 ({smi}): " + json.dumps(info))
    log(f"[9d] ours {out['acc_ours']:.4f} vs random "
        f"{out['acc_random']:.4f}; selection {out['selection_wall_s']:.1f} "
        f"s; paper-scale delay WAN {d['wan']['ours_hours']:.2f} h vs "
        f"oracle {d['wan']['oracle_hours']:.1f} h, pod-DCN "
        f"{d['pod_dcn']['ours_hours']:.4f} h vs "
        f"{d['pod_dcn']['oracle_hours']:.3f} h")
    return info


# ---------------------------------------------------------------------------
# phase 10: the appraisal service
# ---------------------------------------------------------------------------

def _served(srv, specs) -> tuple[list, dict, dict, float]:
    """Submit `specs` to `srv` and drain it, counting each session's
    kernel launches around the server's scheduling quanta (each quantum
    runs one session's work on this thread); returns (sessions, report,
    launches by session id, wall s)."""
    import torch
    step, per = srv._step, {}

    def counted(sess):
        before = _counters()
        step(sess)
        acc = per.setdefault(sess.sid, dict.fromkeys(COUNTERS, 0))
        for n, c in _delta(_counters(), before).items():
            acc[n] += c["kernel"]
    srv._step = counted
    t0 = time.time()
    try:
        sessions = [srv.submit(s) for s in specs]
        rep = srv.run()
        torch.cuda.synchronize()
    finally:
        srv.close()
    return sessions, rep, per, time.time() - t0


def phase_service(seed: int, smi: str, pipeline: dict) -> dict:
    """10a: an `AppraisalServer` on the card (dealer on, default
    max_active) with three sessions over phase 8's BERT-base target: s0
    is 8b's MPC run (the same key, target, pool, step counts, RING32 and
    executor flags), s1 its twin, s2 the same target over a second pool
    (the task of --seed + 1: another data owner). Fatal unless s0's and
    s1's phase scores, survivors and appraisal are bitwise 8b's, s1's
    phases were never executed (cache hits or coalesced waits: 4 of 6
    phases executed), every session's ledger agrees and holds only its
    own flights, s2's phase-1 scores decode finite, and the seven kernels
    launched with no plain version.
    10b: `launch.serve.appraise` at its defaults (TINY target, three
    sessions, the second a twin, RING64): its ledgers agree, the cache
    hits, and the kernels launch with no plain version."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.data.tasks import make_classification_task
    from repro_torch.launch import serve as launch_serve
    from repro_torch.mpc import prng
    from repro_torch.mpc.ring import RING32
    from repro_torch.serve import AppraisalServer, SessionSpec
    params, pool, labels = pipeline["inputs"]
    ref = pipeline["8b mpc result"]
    other = make_classification_task(seed + SEL_SEED_OFFSET + 1,
                                     n_pool=SEL_POOL, n_test=8, seq=SEQ,
                                     vocab=BERT.vocab_size,
                                     n_classes=CLASSES)

    def spec(sid, tok, lab):
        return SessionSpec(
            sid=sid, key=prng.key(seed, device=DEVICE), target_params=params,
            arch_cfg=BERT, pool_tokens=tok,
            sel=_sel_config("mpc", None, RING32, CUT_STEPS),
            n_classes=CLASSES, boot_labels_fn=lambda i: lab[i])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    (s0, s1, s2), rep, per, wall = _served(
        AppraisalServer(device=DEVICE),
        [spec("s0", pool, labels), spec("s1", pool, labels),
         spec("s2", other.pool_tokens, other.pool_labels)])
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = rep["throughput"]
    for s in (s0, s1):
        r = s.result
        same = (len(r.phase_scores) == len(ref.phase_scores)
                and all(np.array_equal(a, b) for a, b in
                        zip(r.phase_scores, ref.phase_scores))
                and np.array_equal(r.selected, ref.selected)
                and np.array_equal(r.appraisal_entropy,
                                   ref.appraisal_entropy, equal_nan=True))
        if not same:
            fail(f"10a {s.sid}: scores, survivors or appraisal differ from "
                 f"8b's MPC run (appraisal {r.appraisal_entropy} against "
                 f"{ref.appraisal_entropy})")
    if s1.cached_phases != [0, 1] or (t["n_phases_executed"],
                                      t["n_phases_total"]) != (4, 6):
        fail(f"10a: s1's cached phases {s1.cached_phases}, "
             f"{t['n_phases_executed']} of {t['n_phases_total']} phases "
             "executed")
    for s in (s0, s1, s2):
        # the flights of the phases it executed (its reports in phase
        # order; a cache hit's report is the executing session's)
        own = [x for i, r in enumerate(s.reports)
               if i not in s.cached_phases for x in r.ledger.records]
        if not s.ledger_agrees() or s.ledger.records != own:
            fail(f"10a {s.sid}: ledger_agrees {s.ledger_agrees()}, "
                 f"{len(s.ledger.records)} flights in its ledger against "
                 f"{len(own)} of its own")
    dec = RING32.decode(torch.as_tensor(s2.result.phase_scores[0]).sum(0))
    if dec.shape != (SEL_POOL - len(s2.result.boot_idx),) or \
            not torch.isfinite(dec).all():
        fail(f"10a s2: phase-1 scores of shape {tuple(dec.shape)} or not "
             "finite")
    # every counted kernel: M_g's finetune (flash_attn forward and
    # backward), the ex-vivo fits (entropy_head), in-vivo
    # (mlp_softmax_attn forward and backward), the RING32 sieve
    # (secure_matmul, ring_matmul)
    missing = [n for n in COUNTERS if counts[n]["kernel"] <= 0]
    if missing or _plain(counts):
        fail(f"10a: not launched {missing}, plain {_plain(counts)}")
    sessions = {s["sid"]: {"wall_s": s["wall_s"],
                           "cached_phases": s["cached_phases"],
                           "appraisal": s["appraisal_entropy"],
                           "device_makespan_s": [p["device_makespan_s"]
                                                 for p in s["phases"]],
                           "launches": per[s["sid"]]}
                for s in rep["sessions"]}
    info = {"wall_s": wall, "sessions": sessions, "throughput": t,
            "cache": rep["cache"], "dealer": rep["dealer"],
            "peak_mem_gb": peak,
            "launches": {n: c["kernel"] for n, c in counts.items()}}
    log(f"[10a] appraisal service, 3 sessions at BERT-base width ({smi}): "
        + json.dumps(info, default=float))
    log(f"[10a] wall {wall:.1f} s; sessions "
        + ", ".join(f"{k} {v['wall_s']:.1f} s" for k, v in sessions.items())
        + f" (8b's MPC run alone: {pipeline['8b mpc ring32']['wall_s']:.1f}"
        f" s); {t['serve_appraisals_per_hour']:.3f} appraisals/h served vs "
        f"{t['sequential_appraisals_per_hour']:.3f} sequential (modelled, "
        f"wan); dealer produced {rep['dealer']['produced_nbytes'] / 1e9:.2f}"
        f" GB, stalled {rep['dealer']['dealer_stall_s']:.3f} s in "
        f"{rep['dealer']['stalls']} stalls; peak {peak:.2f} GB; each "
        "device makespan spans the interleaved sessions' waves on the "
        "shared stream")

    _reset_counters()
    t0 = time.time()
    brep = launch_serve.appraise(device=DEVICE, out_path=None)
    torch.cuda.synchronize()
    bwall = time.time() - t0
    bcounts = _counters()
    missing = [n for n in ("fa", "fa_bwd", "msa", "msa_bwd", "eh", "rmm")
               if bcounts[n]["kernel"] <= 0]
    if brep["ledger_agrees"] is not True or brep["cache"]["hits"] <= 0 \
            or missing or _plain(bcounts):
        fail(f"10b: ledger_agrees {brep['ledger_agrees']}, cache "
             f"{brep['cache']}, not launched {missing}, plain "
             f"{_plain(bcounts)}")
    binfo = {"wall_s": bwall, "throughput": brep["throughput"],
             "cache": brep["cache"], "dealer": brep["dealer"],
             "launches": {n: c["kernel"] for n, c in bcounts.items()}}
    log(f"[10b] launch.serve.appraise at its defaults ({smi}): "
        + json.dumps(binfo, default=float))
    return {"10a": info, "10b": binfo,
            "launches": {n: counts[n]["kernel"] + bcounts[n]["kernel"]
                         for n in COUNTERS}}


# ---------------------------------------------------------------------------
# phase 11: the other protocol backends
# ---------------------------------------------------------------------------

# 11a's and 11b's (protocol, ring bits). 3pc on RING32 is left out: its
# regrouped local shift wraps at about |v| / 2^31 an element
# (tests/test_malicious.py), which is why aby3trunc exists
PROTO_PAIRS = (("3pc", 64), ("aby3trunc", 32), ("aby3trunc", 64),
               ("spdz2pc", 32), ("spdz2pc", 64))
# 11b's rows: one pair a backend (cut from all five for time when phase
# 12 came, PERF.md §6)
PROTO_CPU_PAIRS = (("3pc", 64), ("aby3trunc", 32), ("spdz2pc", 64))
# share rows of each backend: replicated 3 components; SPDZ 2 value rows
# and 2 MAC rows
PROTO_ROWS = {"3pc": 3, "aby3trunc": 3, "spdz2pc": 4}


def phase_protocols(seed: int, proxies, smi: str) -> dict:
    """11a: the executed sieve under replicated3pc (RING64), aby3trunc
    and spdz2pc (both rings) at BERT-base width: phase 3's phase-2
    proxy <3,12,16>, shared under each protocol, and phase 3's executor
    flags (wave, coalesce, overlap, fuse) over one wave of VAR_BATCHES
    batches of BATCH. Fatal unless each phase agrees with its schedule,
    its per-batch ledger equals `costs.proxy_exec_cost` record for
    record, the shares have the backend's rows, the offline channel is
    empty for the dealer-free backends and not for spdz2pc, spdz2pc's
    ledger holds its sacrifices and its MAC check (their dealer records:
    the fused phase folds their opens into its flights), ring_matmul
    launched and secure_matmul did not, no plain version ran and the
    scores are finite. Wall, makespan, rounds, bytes, peak memory,
    launches and max |decoded MPC - ClearEngine| are printed."""
    import numpy as np
    import torch
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.engine import ClearEngine, proxy_entropy
    from repro_torch.mpc import costs, prng, protocols
    from repro_torch.mpc.ring import RING32, RING64
    cfg, specs, pps = proxies
    spec, pp = specs[1], pps[1]
    pool = np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (VAR_BATCHES * BATCH, SEQ))
    tok = torch.as_tensor(pool, device=DEVICE)
    clear = torch.cat([proxy_entropy(ClearEngine(), pp, cfg,
                                     tok[i:i + BATCH], spec)
                       for i in range(0, len(tok), BATCH)]).double()
    out, rmm = {}, 0
    for proto, bits in PROTO_PAIRS:
        ring = RING32 if bits == 32 else RING64
        backend = protocols.get(proto)
        tag = f"{proto} {ring.name}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        ex = WaveExecutor(ExecConfig(wave=WAVE, coalesce=True, overlap=True,
                                     fuse=True, batch=BATCH, ring=ring,
                                     protocol=proto, device=DEVICE))
        t0 = time.time()
        ent = ex.score_phase(prng.key(seed + 110, device=DEVICE), pp, cfg,
                             pool, spec)
        vals = ring.decode(backend.reconstruct(ent.sh)).double()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _counters()
        rep = ex.reports[-1]
        led = rep.ledger
        mirror = costs.proxy_exec_cost(
            BATCH, SEQ, cfg.d_model, spec.n_heads, cfg.n_kv_heads,
            cfg.d_head, spec.mlp_dim, CLASSES, spec.n_layers, ring=ring,
            protocol=proto, fused=True)
        ops_ = {r.op for r in led.records}
        if not rep.agrees():
            fail(f"11a {tag}: ledger does not agree with the schedule")
        if _mirror_stream(rep.per_batch) != _mirror_stream(mirror):
            fail(f"11a {tag}: the per-batch ledger differs from "
                 "costs.proxy_exec_cost")
        if tuple(ent.sh.shape) != (PROTO_ROWS[proto], len(pool)):
            fail(f"11a {tag}: shares of shape {tuple(ent.sh.shape)}")
        if (led.offline_nbytes > 0) != (proto == "spdz2pc"):
            fail(f"11a {tag}: offline bytes {led.offline_nbytes}")
        # the fused phase folds the sacrifice and MAC-check opens into
        # its flights; their dealer records stay by name
        if proto == "spdz2pc" and not ({"offline.sacrifice_triple",
                                        "offline.sacrifice_matmul_triple",
                                        "offline.mac_key"} <= ops_):
            fail(f"11a {tag}: no sacrifice or MAC-check records ({ops_})")
        if counts["rmm"]["kernel"] <= 0 or counts["smm"]["kernel"]:
            fail(f"11a {tag}: ring_matmul {counts['rmm']}, secure_matmul "
                 f"{counts['smm']}")
        if _plain(counts):
            fail(f"11a {tag}: a plain version ran ({_plain(counts)})")
        if not torch.isfinite(vals).all():
            fail(f"11a {tag}: non-finite scores")
        rmm += counts["rmm"]["kernel"]
        info = {"wall_s": wall, "device_makespan_s": rep.device_makespan_s,
                "rounds": led.rounds, "lat_rounds": led.lat_rounds,
                "bw_rounds": led.bw_rounds, "online_gb": led.nbytes / 1e9,
                "offline_gb": led.offline_nbytes / 1e9,
                "per_batch": {"rounds": mirror.rounds,
                              "online_gb": mirror.nbytes / 1e9,
                              "offline_gb": mirror.offline_nbytes / 1e9,
                              "records": len(mirror.records)},
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {n: c["kernel"] for n, c in counts.items()
                             if c["kernel"]},
                "max_abs_mpc_minus_clear": float(
                    (vals - clear).abs().max())}
        log(f"[11a] {tag} <{spec.n_layers},{spec.n_heads},{spec.mlp_dim}>, "
            f"{len(pool)} candidates ({smi}): " + json.dumps(info))
        out[tag] = info
    out["launches"] = {"ring_matmul": rmm}
    return out


def _small_protocol_forward(seed: int, proto: str, ring, phase: int = 1):
    """11b's one row at depth CPU_LAYERS and seq VAR_SEQ (BERT-base
    widths) of phase 3's proxy `phase` (heads and MLP width), shared
    under `proto` on the CPU: (proxy shares, input share, engine key,
    spec)."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.proxy import ProxySpec, random_proxy, share_proxy
    from repro_torch.mpc import prng
    from repro_torch.mpc.sharing import share
    spec = ProxySpec(CPU_LAYERS, *PHASES[phase][1:])
    pp = random_proxy(torch.Generator().manual_seed(seed + 111), BERT, spec,
                      VAR_SEQ, CLASSES, device="cpu")
    emb = pp.pop("embed")
    tok = np.random.default_rng(seed + 112).integers(0, BERT.vocab_size,
                                                     (1, VAR_SEQ))
    x = emb[torch.as_tensor(tok)] * float(np.float32(BERT.d_model ** 0.5))
    key = prng.key(seed + 113)
    return (share_proxy(prng.fold_in(key, 1), pp, ring, proto),
            share(prng.fold_in(key, 2), x, ring, proto),
            prng.fold_in(key, 3), spec)


def phase_protocols_card_vs_cpu(seed: int) -> None:
    """11b: each (protocol, ring) of PROTO_CPU_PAIRS, one row at depth
    CPU_LAYERS and seq VAR_SEQ, on the card and on the CPU with the same
    keys: shares bitwise equal."""
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.engine import MPCEngine, proxy_entropy
    from repro_torch.mpc.ring import RING32, RING64
    for proto, bits in PROTO_CPU_PAIRS:
        ring = RING32 if bits == 32 else RING64
        pp_sh, x_sh, k, spec = _small_protocol_forward(seed, proto, ring)
        got = {}
        for dev in (DEVICE, "cpu"):
            d = torch.device(dev)
            eng = MPCEngine(ring, protocol=proto).with_key(k.to(d))
            t0 = time.time()
            ent = proxy_entropy(eng, _on(pp_sh, d), BERT,
                                x_sh.with_sh(x_sh.sh.to(d)), spec)
            got[dev] = (ent.sh.cpu(), time.time() - t0)
        if not torch.equal(got[DEVICE][0], got["cpu"][0]):
            fail(f"11b {proto} {ring.name}: card and CPU shares differ")
        log(f"[11b] {proto} {ring.name}: card == CPU, bitwise, "
            f"{tuple(got['cpu'][0].shape)} (card {got[DEVICE][1]:.2f} s, "
            f"CPU {got['cpu'][1]:.2f} s)")


def phase_malicious(seed: int, proxies, smi: str) -> dict:
    """11c: the malicious tier on the card. One eager `proxy_entropy`
    over MPCEngine(RING64, "spdz2pc") of one batch of BATCH at 11a's
    width and depth, inside `mac_scope` and not under vmap: it must pass
    the boundary MAC check with obligations opened and none unread.
    Then 11b's small forward under `tamper_scope`, one bit of row 0
    flipped at the first partial open: it must raise MacCheckError at
    `MPCEngine.entropy_head`."""
    import traceback
    import numpy as np
    import torch
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core.proxy import share_proxy
    from repro_torch.engine import MPCEngine, proxy_entropy
    from repro_torch.mpc import prng
    from repro_torch.mpc.protocols.spdz2pc import (MacCheckError, mac_scope,
                                                   tamper_scope)
    from repro_torch.mpc.ring import RING64
    from repro_torch.mpc.sharing import share
    cfg, specs, pps = proxies
    spec, pp = specs[1], pps[1]
    key = prng.key(seed + 114, device=DEVICE)
    pp_sh = share_proxy(prng.fold_in(key, 1), pp, RING64, "spdz2pc")
    tok = torch.as_tensor(np.random.default_rng(seed + 115).integers(
        0, cfg.vocab_size, (BATCH, SEQ)), device=DEVICE)
    x = pp["embed"][tok] * float(np.float32(cfg.d_model ** 0.5))
    x_sh = share(prng.fold_in(key, 2), x, RING64, "spdz2pc")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.time()
    with mac_scope() as st:
        ent = proxy_entropy(MPCEngine(RING64, protocol="spdz2pc").with_key(
            prng.fold_in(key, 3)), pp_sh, cfg, x_sh, spec)
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _counters()
    if st.n_opened <= 0 or st.n_traced or st.flags:
        fail(f"11c: honest forward: {st.n_opened} opened, {st.n_traced} "
             f"unread, {len(st.flags)} unchecked")
    if tuple(ent.sh.shape) != (4, BATCH) or counts["rmm"]["kernel"] <= 0 \
            or _plain(counts):
        fail(f"11c: shares {tuple(ent.sh.shape)}, launches {counts}")
    info = {"wall_s": wall, "n_opened": st.n_opened,
            "n_traced": st.n_traced,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ring_matmul": counts["rmm"]["kernel"]}

    def flip(sh):
        sh = sh.clone()
        sh.view(sh.shape[0], -1)[0, 0] ^= 1 << 5
        return sh

    pp_s, x_s, k, sspec = _small_protocol_forward(seed, "spdz2pc", RING64)
    dev = torch.device(DEVICE)
    where = None
    with mac_scope() as st2:
        try:
            with tamper_scope(flip):
                proxy_entropy(MPCEngine(RING64, protocol="spdz2pc")
                              .with_key(k.to(dev)), _on(pp_s, dev), BERT,
                              x_s.with_sh(x_s.sh.to(dev)), sspec)
        except MacCheckError as e:
            where = [f.name for f in traceback.extract_tb(e.__traceback__)]
            info["tamper_error"] = str(e)
    if where is None or "entropy_head" not in where:
        fail(f"11c: the tampered forward did not abort at entropy_head "
             f"({where})")
    info["tamper_opened"] = st2.n_opened
    log(f"[11c] spdz2pc RING64 at <{spec.n_layers},{spec.n_heads},"
        f"{spec.mlp_dim}>, one eager batch of {BATCH} ({smi}): "
        + json.dumps(info))
    return {"11c": info, "launches": {"ring_matmul":
                                      counts["rmm"]["kernel"]}}


# ---------------------------------------------------------------------------
# phase 12: the real wire
# ---------------------------------------------------------------------------

CHAOS_SEED = 123
# 12's depth: every wired phase runs a depth-1 proxy (a tape is host
# bytes, and the socket wire paces wan at 100 MB/s a link), one batch of
# BATCH at SEQ: <1,12,16> is 0.871 GB online on RING32 2pc, <1,1,2> 0.316
WIRE_LAYERS = 1


def _wired(seed, cfg, spec, pp, pool, ring, proto="2pc", **kw):
    """One executed phase through `WaveExecutor`'s config checks and a
    `PhaseRun` (kept for its tape), with the launch counters reset just
    before it and read just after: (scores, report, tape, counts, wall
    with the wire's replay, peak device GB). The report's `wall_s` stops
    before the replay."""
    import torch
    from repro_torch.core.executor import ExecConfig, PhaseRun, WaveExecutor
    from repro_torch.mpc import prng
    ex = WaveExecutor(ExecConfig(wave=WAVE, overlap=True, fuse=True,
                                 batch=BATCH, ring=ring, protocol=proto,
                                 device=DEVICE, **kw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.time()
    run = PhaseRun(ex.cfg, prng.key(seed + 120, device=DEVICE), pp, cfg,
                   pool, spec)
    for wi in range(run.n_waves):
        run.dispatch(wi)
    run.drain()
    ent, rep = run.finish()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return (ent.sh.cpu(), rep, run.tape, _counters(), wall,
            torch.cuda.max_memory_allocated() / 1e9)


def _wire_gates(tag, rep, counts, kernel, scores, ref) -> None:
    """What every wired phase of 12a-12d must show."""
    import torch
    w = rep.wire
    if not torch.equal(scores, ref):
        fail(f"{tag}: wired scores differ from the unwired run's")
    if not rep.agrees():
        fail(f"{tag}: ledger does not agree with the schedule")
    if not (w.bytes_match and w.digests_ok):
        fail(f"{tag}: wire {w.wire_nbytes} B against the tape's "
             f"{w.tape_nbytes}, digests_ok {w.digests_ok}")
    if counts[kernel]["kernel"] <= 0 or _plain(counts):
        fail(f"{tag}: {kernel} {counts[kernel]}, plain {_plain(counts)}")


def _wire_info(rep, wall, peak) -> dict:
    w = rep.wire
    return {"tape_gb": w.tape_nbytes / 1e9, "flights": w.n_flights,
            "msgs": w.n_msgs, "wire_gb": w.wire_nbytes / 1e9,
            "wire_makespan_s": w.wire_makespan_s,
            "per_party_s": w.per_party_s, "score_wall_s": rep.wall_s,
            "wall_with_replay_s": wall, "peak_mem_gb": peak}


def phase_wire(seed: int, proxies, smi: str) -> dict:
    """12a-12d: the executor's real wire at BERT-base width, one batch of
    BATCH at SEQ (one wave), each wired phase against the same phase
    unwired (`wire="none", coalesce=False`, the schedule a wire forces).
    (12a) phase 3's phase-2 proxy cut to WIRE_LAYERS (<1,12,16>), RING32
    2pc, fused, `wire="local"`: bitwise scores, agreement, the per-batch
    ledger equal to `costs.proxy_exec_cost` record for record, bytes and
    digests, goodput equal to the ledger's online bytes, secure_matmul
    launched and no plain version. (12b) the same over `wire="socket"`
    at wan (one spawned process a party, paced localhost TCP): 12a's
    gates and 12a's scores; the measured wire_makespan_s beside the
    model's `makespan(WAN)` of the same stream (printed, not gated).
    (12c) phase 3's phase-1 proxy <1,1,2>, RING32 2pc, socket at pod_dcn
    under `chaos_seed=CHAOS_SEED`: bitwise, bytes and digests, faults
    injected and retried, one respawn that recovered, the plan the same
    JSON twice. (12d) <1,1,2> under 3pc RING64, local, chaos and
    `degraded`: 2-of-3 after a crash at the boundary, bytes against the
    filtered tape, bitwise scores, ring_matmul with no plain version."""
    import numpy as np
    from repro_torch import net
    from repro_torch.mpc import costs
    from repro_torch.mpc.comm import WAN
    from repro_torch.mpc.ring import RING32, RING64
    from repro_torch.net import faults
    cfg, specs, pps = proxies
    pool = np.random.default_rng(seed + 12).integers(0, cfg.vocab_size,
                                                     (BATCH, SEQ))
    out = {}
    launches = {"ring_matmul": 0, "secure_matmul": 0}

    def count(counts):
        launches["ring_matmul"] += counts["rmm"]["kernel"]
        launches["secure_matmul"] += counts["smm"]["kernel"]

    # 12a: the local wire at <1,12,16>
    spec, pp = _cut_proxy(specs[1], pps[1], WIRE_LAYERS)
    ref, rep0, _, c0, _, _ = _wired(seed, cfg, spec, pp, pool, RING32,
                                    wire="none", coalesce=False)
    count(c0)
    got, rep, tape, counts, wall, peak = _wired(
        seed, cfg, spec, pp, pool, RING32, wire="local")
    count(counts)
    _wire_gates("12a", rep, counts, "smm", got, ref)
    mirror = costs.proxy_exec_cost(
        BATCH, SEQ, cfg.d_model, spec.n_heads, cfg.n_kv_heads, cfg.d_head,
        spec.mlp_dim, CLASSES, spec.n_layers, ring=RING32, fused=True)
    if _mirror_stream(rep.per_batch) != _mirror_stream(mirror):
        fail("12a: the per-batch ledger differs from costs.proxy_exec_cost")
    if rep.wire.wire_nbytes != rep.ledger.nbytes:
        fail(f"12a: wire {rep.wire.wire_nbytes} B, ledger "
             f"{rep.ledger.nbytes} B")
    info = _wire_info(rep, wall, peak)
    info.update(unwired_score_wall_s=rep0.wall_s,
                capture_cost_s=rep.wall_s - rep0.wall_s,
                largest_flight_gb=max(f.nbytes for f in tape.flights) / 1e9,
                secure_matmul=counts["smm"]["kernel"],
                ring_matmul=counts["rmm"]["kernel"])
    out["12a"] = info
    log(f"[12a] local wire, RING32 2pc <{spec.n_layers},{spec.n_heads},"
        f"{spec.mlp_dim}>, one batch of {BATCH} ({smi}): "
        + json.dumps(info))

    # 12b: the same phase over sockets at wan
    got, rep, _, counts, wall, peak = _wired(
        seed, cfg, spec, pp, pool, RING32, wire="socket", net="wan")
    count(counts)
    _wire_gates("12b", rep, counts, "smm", got, ref)
    if rep.wire.wire_nbytes != rep.ledger.nbytes or rep.wire.mode != "socket":
        fail(f"12b: {rep.wire.mode} wire {rep.wire.wire_nbytes} B, ledger "
             f"{rep.ledger.nbytes} B")
    info = _wire_info(rep, wall, peak)
    model = rep.makespan(WAN)
    info.update(model_makespan_wan_s=model,
                measured_over_model=rep.wire.wire_makespan_s / model,
                secure_matmul=counts["smm"]["kernel"])
    out["12b"] = info
    log(f"[12b] socket wire at wan, same phase ({smi}): "
        + json.dumps(info))

    # 12c: chaos over sockets at <1,1,2>
    spec, pp = _cut_proxy(specs[0], pps[0], WIRE_LAYERS)
    ref, _, _, c0, _, _ = _wired(seed, cfg, spec, pp, pool, RING32,
                                 wire="none", coalesce=False)
    count(c0)
    got, rep, tape, counts, wall, peak = _wired(
        seed, cfg, spec, pp, pool, RING32, wire="socket", net="pod_dcn",
        chaos_seed=CHAOS_SEED)
    count(counts)
    _wire_gates("12c", rep, counts, "smm", got, ref)
    w = rep.wire
    plan = faults.FaultPlan.from_tape(CHAOS_SEED, tape).to_json()
    if plan != faults.FaultPlan.from_tape(CHAOS_SEED, tape).to_json() \
            or plan != w.fault_plan:
        fail("12c: FaultPlan.from_tape is not deterministic")
    if not (w.faults_injected > 0 and w.retries > 0 and w.respawns == 1
            and w.recovery_time_s > 0):
        fail(f"12c: faults {w.faults_injected}, retries {w.retries}, "
             f"respawns {w.respawns}, recovery {w.recovery_time_s} s")
    info = _wire_info(rep, wall, peak)
    info.update({k: getattr(w, k) for k in (
        "faults_injected", "retries", "respawns", "recovery_time_s",
        "retrans_bytes", "ack_bytes", "dup_frames", "reconnects")})
    info["plan"] = json.loads(plan)
    out["12c"] = info
    log(f"[12c] chaos over sockets at pod_dcn, RING32 2pc <{spec.n_layers},"
        f"{spec.n_heads},{spec.mlp_dim}> ({smi}): " + json.dumps(info))

    # 12d: degraded 2-of-3 under 3pc
    ref, _, _, c0, _, _ = _wired(seed, cfg, spec, pp, pool, RING64,
                                 "3pc", wire="none", coalesce=False)
    count(c0)
    got, rep, tape, counts, wall, peak = _wired(
        seed, cfg, spec, pp, pool, RING64, "3pc", wire="local",
        chaos_seed=CHAOS_SEED, degraded=True)
    count(counts)
    _wire_gates("12d", rep, counts, "rmm", got, ref)
    w = rep.wire
    if not w.degraded or len(w.dead_parties) != 1:
        fail(f"12d: degraded {w.degraded}, dead {w.dead_parties}")
    filtered = net.filter_tape(tape, w.dead_parties[0])
    if w.tape_nbytes != filtered.nbytes or w.wire_nbytes != filtered.nbytes:
        fail(f"12d: wire {w.wire_nbytes} B, filtered tape "
             f"{filtered.nbytes} B")
    info = _wire_info(rep, wall, peak)
    info.update(dead_parties=w.dead_parties, full_tape_gb=tape.nbytes / 1e9,
                faults_injected=w.faults_injected, retries=w.retries,
                ring_matmul=counts["rmm"]["kernel"])
    out["12d"] = info
    log(f"[12d] degraded 2-of-3, RING64 3pc <{spec.n_layers},"
        f"{spec.n_heads},{spec.mlp_dim}> ({smi}): " + json.dumps(info))
    out["launches"] = launches
    return out


def phase_wire_card_vs_cpu(seed: int) -> None:
    """12e: 12c's forward (phase 3's phase-1 proxy) at depth CPU_LAYERS
    and seq VAR_SEQ, one row, 2pc on RING32 and RING64, fused, captured
    into a wire tape on the card and on the CPU with the same keys: the
    tapes must be equal message for message and `expected_digests`
    agree, and the tape must carry share bytes (not all filler)."""
    import torch
    from repro_torch import net
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.engine import MPCEngine, proxy_entropy
    from repro_torch.mpc import comm, fusion
    from repro_torch.mpc.ring import RING32, RING64
    for ring in (RING32, RING64):
        pp_sh, x_sh, k, spec = _small_protocol_forward(seed + 12, "2pc",
                                                       ring, phase=0)
        tapes = {}
        for dev in (DEVICE, "cpu"):
            d = torch.device(dev)
            tape = comm.WireTape(2)
            t0 = time.time()
            with comm.ledger_scope(), comm.wire_tape_scope(tape), \
                    fusion.flight_scope():
                proxy_entropy(MPCEngine(ring).with_key(k.to(d)),
                              _on(pp_sh, d), BERT,
                              x_sh.with_sh(x_sh.sh.to(d)), spec)
            tapes[dev] = (tape, time.time() - t0)
        card, cpu = tapes[DEVICE][0], tapes["cpu"][0]
        msgs = [[(m.src, m.dst, m.rnd, m.data) for m in f.msgs]
                for f in card.flights]
        if [(f.op, f.rounds, f.nbytes, f.tag) for f in card.flights] != \
                [(f.op, f.rounds, f.nbytes, f.tag) for f in cpu.flights] \
                or msgs != [[(m.src, m.dst, m.rnd, m.data) for m in f.msgs]
                            for f in cpu.flights]:
            fail(f"12e {ring.name}: card and CPU tapes differ")
        if net.expected_digests(card, 2) != net.expected_digests(cpu, 2):
            fail(f"12e {ring.name}: card and CPU digests differ")
        share_bytes = sum(len(m.data) for f in card.flights for m in f.msgs
                          if m.data.count(0) < len(m.data))
        if share_bytes <= 0:
            fail(f"12e {ring.name}: the tape carries filler only")
        log(f"[12e] {ring.name} 2pc <{spec.n_layers},{spec.n_heads},"
            f"{spec.mlp_dim}> seq {VAR_SEQ}: card tape == CPU tape, "
            f"{len(card.flights)} flights, {card.nbytes / 1e6:.1f} MB, "
            f"{share_bytes / card.nbytes:.3f} of it in messages that are "
            f"not all zero (card {tapes[DEVICE][1]:.2f} s, CPU "
            f"{tapes['cpu'][1]:.2f} s)")


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2_0_5b"
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_BATCH, TRAIN_SEQ = 16, 20, 8, 128
# 13b: arch -> (layers, rows, tokens), full width with depth cut for chip
# time and memory: one (rec, rec, attn) pattern of RecurrentGemma's 26
# layers, 2 of Mamba-2's 64 and 2 of PaliGemma's 18 (its rows 256 stub
# patches + the tokens)
TRAIN_CUT = {"recurrentgemma_2b": (3, 2, 512), "mamba2_2_7b": (2, 2, 512),
             "paligemma_3b": (2, 2, 512)}
TRAIN_CUT_STEPS = 3
# 13c: one row of this many tokens (the vlm's 256 patches before them),
# depth 1 (one block pattern for the hybrid family), float32
TRAIN_CPU_SEQ = 32
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_COUNTERS = ("fa", "fa_bwd", "ssd", "ssd_bwd", "lru", "lru_bwd", "msa",
                  "msa_bwd", "eh", "rmm", "smm")


def _train_counts() -> dict:
    from repro_torch.kernels import ops as kops
    return {n: getattr(kops, f"{n}_stats")() for n in TRAIN_COUNTERS}


def _train_reset() -> None:
    from repro_torch.kernels import ops as kops
    for n in TRAIN_COUNTERS:
        getattr(kops, f"reset_{n}_stats")()


def _train_gates(tag: str, counts: dict, need: tuple, losses) -> None:
    import math
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"[13] {tag}: losses not finite: {losses}")
    plain = {n: c["ref"] for n, c in counts.items() if c["ref"]}
    if plain:
        fail(f"[13] {tag}: plain versions ran: {plain}")
    for n in need:
        if counts[n]["kernel"] == 0:
            fail(f"[13] {tag}: kernel {n} never launched ({counts})")


def _lm_batch(cfg, seed: int, step: int, rows: int, tokens: int, dev,
              gen=None) -> dict:
    """Tokens and labels from the data pipeline's addressing, on `dev`,
    and the vlm family's stub patches from `gen` (numpy without one)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synth_lm_batch
    b = {k: torch.as_tensor(v, device=dev) for k, v in synth_lm_batch(
        seed, step, 0, 1, rows, tokens, cfg.vocab_size).items()}
    if cfg.family == "vlm":
        shape = (rows, cfg.n_prefix_tokens, cfg.d_model)
        b["patches"] = (torch.randn(shape, generator=gen, device=dev)
                        if gen is not None else torch.as_tensor(
                            np.random.default_rng(seed).standard_normal(
                                shape).astype(np.float32), device=dev))
    return b


def phase_train(seed: int, smi: str) -> dict:
    """Training on the card, the zoo's `launch.train` path. (13a) `train`
    on qwen2_0_5b at full width and depth for TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ with remat and a checkpoint at the last,
    then a second `train` to TRAIN_RESUME_STEPS that must resume from
    it: finite losses falling from the first to the last, flash_attn's
    forward and backward kernels launched and no plain version; the step
    wall, tokens/s, peak memory and checkpoint wall, and one profiled
    step (busy share, top kernels, the backward kernel's share). (13b)
    `make_train_step`, TRAIN_CUT_STEPS steps at full width with depth cut
    (TRAIN_CUT) for recurrentgemma_2b (rg_lru's and flash_attn's Dh-256
    windowed backward), mamba2_2_7b (ssd's) and paligemma_3b (the prefix
    backward): finite losses, the backward kernels launched, no plain
    version. (13c) One train step's loss and gradients, the card against
    the CPU, float32, depth 1, one row, for those three and qwen2_0_5b:
    the loss within TRAIN_LOSS_TOL of |CPU|, every gradient leaf within
    TRAIN_GRAD_TOL of that leaf's max |CPU|."""
    import dataclasses
    import shutil
    import statistics
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import load_arch
    from repro_torch.core import tree
    from repro_torch.launch import train as tr
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    out = {"launches": {}, "walls_s": {}}
    t13 = time.time()

    def add_launches(counts):
        for n, c in counts.items():
            out["launches"][n] = out["launches"].get(n, 0) + c["kernel"]

    # ---- 13a: launch.train, then a resumed run -------------------------
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        _train_reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        first = tr.train(tr.TrainConfig(
            arch=TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=ckpt,
            ckpt_every=TRAIN_STEPS, log_every=4, seed=seed, device=DEVICE))
        wall1 = time.time() - t0
        t0 = time.time()
        second = tr.train(tr.TrainConfig(
            arch=TRAIN_ARCH, smoke=False, steps=TRAIN_RESUME_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=ckpt,
            ckpt_every=TRAIN_STEPS, log_every=4, seed=seed, device=DEVICE))
        wall2 = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = _train_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _train_gates("13a", counts, ("fa", "fa_bwd"),
                 first["losses"] + second["losses"])
    if not first["losses"][-1] < first["losses"][0]:
        fail(f"[13a] loss did not fall: {first['losses']}")
    if second["resumed_from"] != TRAIN_STEPS:
        fail(f"[13a] the second run resumed from {second['resumed_from']}, "
             f"not {TRAIN_STEPS}")
    add_launches(counts)
    step_s = statistics.median(first["step_s"][1:])
    a = out["13a"] = {
        "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": first["losses"], "resumed_losses": second["losses"],
        "step_ms": 1e3 * step_s, "first_step_ms": 1e3 * first["step_s"][0],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "peak_gb": peak, "ckpt_s": first["ckpt_s"],
        "resumed_ckpt_s": second["ckpt_s"],
        "restore_s": second["restore_s"], "wall_s": wall1,
        "resumed_wall_s": wall2,
        "launches": {n: c["kernel"] for n, c in counts.items()
                     if c["kernel"]}, "card": smi}
    log(f"[13a] {TRAIN_ARCH} full width, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat: loss {first['losses'][0]:.4f}"
        f" -> {first['losses'][-1]:.4f}; resumed at "
        f"{second['resumed_from']} -> {second['losses'][-1]:.4f}; step "
        f"{a['step_ms']:.1f} ms (first {a['first_step_ms']:.0f} ms), "
        f"{a['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB, checkpoint "
        f"{first['ckpt_s']:.2f} s (resumed run's {second['ckpt_s']:.2f} s, "
        f"its restore {second['restore_s']:.2f} s), "
        f"walls {wall1:.1f} + {wall2:.1f} s; launches {a['launches']} "
        f"({smi})")

    out["walls_s"]["13a"] = time.time() - t13

    # one profiled step of the same model and batch
    t13 = time.time()
    cfg = load_arch(TRAIN_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_params(gen, cfg, DEVICE)
    opt = init_opt_state(params)
    step = tr.make_train_step(cfg, AdamWConfig(total_steps=4,
                                               warmup_steps=1), True)
    batch = _lm_batch(cfg, seed, 0, TRAIN_BATCH, TRAIN_SEQ, DEVICE)
    params, opt, _, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        params, opt, loss, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = _device_events(prof)
    busy = sum(_event_ms(e) for e in events)
    bwd = sum(_event_ms(e) for e in events if "fa_bwd" in e.key)
    fwd = sum(_event_ms(e) for e in events
              if re.search(r"\bflash_attn_kernel\b", e.key))
    top = [(e.key[:80], round(_event_ms(e), 4), e.count) for e in
           sorted(events, key=_event_ms, reverse=True)[:5]]
    a["profile"] = {"wall_ms": 1e3 * wall, "kernel_ms": busy,
                    "busy_share": busy / (1e3 * wall),
                    "fa_bwd_ms": bwd, "fa_bwd_share": bwd / max(busy, 1e-9),
                    "fa_ms": fwd, "top": top}
    log(f"[13a] one profiled step: wall {1e3 * wall:.1f} ms, kernels "
        f"{busy:.1f} ms (busy {100 * busy / (1e3 * wall):.1f} %), "
        f"flash_attn backward {bwd:.2f} ms "
        f"({100 * a['profile']['fa_bwd_share']:.1f} % of kernel time), "
        f"forward {fwd:.2f} ms; top {top}")
    del params, opt, step, batch, prof, events
    torch.cuda.empty_cache()
    out["walls_s"]["13a profile"] = time.time() - t13

    # ---- 13b: make_train_step at full width, depth cut -----------------
    need = {"recurrentgemma_2b": ("lru", "lru_bwd", "fa", "fa_bwd"),
            "mamba2_2_7b": ("ssd", "ssd_bwd"),
            "paligemma_3b": ("fa", "fa_bwd")}
    out["13b"] = {}
    t13 = time.time()
    for arch, (layers, rows, tokens) in TRAIN_CUT.items():
        cfg = dataclasses.replace(load_arch(arch), n_layers=layers)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        params = T.init_params(gen, cfg, DEVICE)
        opt = init_opt_state(params)
        step = tr.make_train_step(
            cfg, AdamWConfig(total_steps=TRAIN_CUT_STEPS, warmup_steps=1),
            True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _train_reset()
        losses, walls = [], []
        for i in range(TRAIN_CUT_STEPS):
            batch = _lm_batch(cfg, seed, i, rows, tokens, DEVICE, gen)
            t0 = time.time()
            params, opt, loss, gn = step(params, opt, batch)
            losses.append(float(loss))
            walls.append(time.time() - t0)
        counts = _train_counts()
        _train_gates(f"13b {arch}", counts, need[arch], losses)
        add_launches(counts)
        r = out["13b"][arch] = {
            "layers": layers, "rows": rows, "tokens": tokens,
            "losses": losses, "step_ms": 1e3 * statistics.median(walls[1:]),
            "first_step_ms": 1e3 * walls[0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {n: c["kernel"] for n, c in counts.items()
                         if c["kernel"]}}
        log(f"[13b] {arch} full width, {layers} layers, {rows} x {tokens}"
            f"{' (+256 patches)' if cfg.family == 'vlm' else ''}: losses "
            f"{[round(x, 4) for x in losses]}, step {r['step_ms']:.1f} ms "
            f"(first {r['first_step_ms']:.0f}), peak {r['peak_gb']:.2f} GB; "
            f"launches {r['launches']}")
        del params, opt, step, batch
        torch.cuda.empty_cache()

    out["walls_s"]["13b"] = time.time() - t13

    # ---- 13c: one step's loss and gradients, card against CPU ----------
    out["13c"] = {}
    for arch in (TRAIN_ARCH,) + tuple(TRAIN_CUT):
        t13 = time.time()
        full = load_arch(arch)
        layers = len(full.block_pattern) if full.family == "hybrid" else 1
        cfg = dataclasses.replace(full, n_layers=layers, dtype="float32")
        # drawn on the card (the CPU's draw of a full-width vocabulary
        # takes seconds) and copied once to the CPU
        on_card = T.init_params(
            torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
        names = ["/".join(k) for k in _leaf_paths(on_card)]
        res = {}
        for dev, params in (("cpu", tree.to_device(on_card, "cpu")),
                            (DEVICE, on_card)):
            p, leaves = tree.trainable(params)
            batch = _lm_batch(cfg, seed, 0, 1, TRAIN_CPU_SEQ, dev)
            _train_reset()
            loss, _ = T.train_loss(p, cfg, batch, remat=True)
            g = tree.grads(loss, leaves)
            res[dev] = (float(loss.detach()), g)
            if dev == DEVICE:
                counts = _train_counts()
                _train_gates(f"13c {arch}", counts,
                             need.get(arch, ("fa", "fa_bwd")), [res[dev][0]])
                add_launches(counts)
            del p, leaves, g, loss, params
        # each leaf's error taken on the card, the CPU's gradient copied
        # there
        (lc, gc), (lg, gg) = res["cpu"], res[DEVICE]
        worst = (0.0, "")
        for x, y, n in zip(gg, gc, names):
            y = y.to(DEVICE)
            worst = max(worst, (float((x - y).abs().max())
                                / max(float(y.abs().max()), 1e-30), n))
        loss_err = abs(lg - lc) / abs(lc)
        out["13c"][arch] = {"loss_cpu": lc, "loss_card": lg,
                            "loss_rel_err": loss_err,
                            "worst_leaf": worst[1],
                            "worst_leaf_rel_err": worst[0]}
        log(f"[13c] {arch} depth {layers}, one row of {TRAIN_CPU_SEQ}: loss "
            f"card {lg:.6f} CPU {lc:.6f} ({loss_err:.2e} of |CPU|, limit "
            f"{TRAIN_LOSS_TOL}); worst gradient leaf {worst[1]} "
            f"{worst[0]:.2e} of its max |CPU| (limit {TRAIN_GRAD_TOL})")
        if not loss_err <= TRAIN_LOSS_TOL:
            fail(f"[13c] {arch}: loss {lg} on the card, {lc} on the CPU")
        if not worst[0] <= TRAIN_GRAD_TOL:
            fail(f"[13c] {arch}: gradient {worst[1]} off by {worst[0]:.3g} "
                 f"of its max |CPU|")
        del on_card, res, gc, gg
        out["walls_s"][f"13c {arch}"] = time.time() - t13
    torch.cuda.empty_cache()
    log("[13] walls (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in out["walls_s"].items()))
    return out


def _leaf_paths(tr_, path=()):
    """Key paths of a parameter tree in `core.tree.tree_leaves` order."""
    if isinstance(tr_, dict):
        return [q for k in sorted(tr_) for q in _leaf_paths(tr_[k],
                                                            path + (k,))]
    return [path]


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
    fa_sass = phase_sass("flash_attn", FA_ENTRIES, FA_NO_SPILL, "HGMMA")
    rmm_sass = phase_sass("ring_matmul", RMM_ENTRIES, RMM_ENTRIES, "IGMMA")
    smm_sass = phase_sass("secure_matmul", SMM_ENTRIES, SMM_ENTRIES, "IGMMA")
    ssd_sass = phase_sass("ssd", SSD_ENTRIES, SSD_NO_SPILL, "HGMMA")
    msa_build = phase_sass("mlp_softmax_attn", MSA_ENTRIES, MSA_NO_SPILL,
                           forbid=NO_ATOMICS)
    eh_build = phase_sass("entropy_head", EH_ENTRIES, EH_NO_SPILL,
                          forbid=NO_ATOMICS)
    lru_entries_ = lru_entries()
    lru_build = phase_sass("rg_lru", lru_entries_, lru_entries_,
                           forbid=NO_ATOMICS)
    fa_bwd_build = phase_sass("flash_attn_bwd",
                              {**FA_BWD_ENTRIES, **FA_BWD256_ENTRIES},
                              FA_BWD_NO_SPILL + FA_BWD256_NO_SPILL, "HGMMA",
                              forbid=NO_ATOMICS,
                              exempt=FA_BWD256_CUDA_CORES)
    ssd_bwd_build = phase_sass("ssd_bwd", SSD_BWD_ENTRIES, SSD_BWD_NO_SPILL,
                               "HGMMA", forbid=NO_ATOMICS,
                               exempt=SSD_BWD_CUDA_CORES)
    lru_bwd_build = phase_sass("rg_lru_bwd", LRU_BWD_ENTRIES,
                               LRU_BWD_ENTRIES, forbid=NO_ATOMICS)
    msa_bwd_build = phase_sass("mlp_softmax_attn_bwd", MSA_BWD_ENTRIES,
                               MSA_BWD_NO_SPILL, forbid=NO_ATOMICS)
    kern = phase_kernels(args.seed)
    fkern = phase_float_kernels(args.seed)
    bkern = phase_backward_kernels(args.seed)
    skern = phase_scan_kernels(args.seed)
    tkern = phase_train_kernels(args.seed)
    proxies = build_proxies(args.seed)
    t0 = time.time()
    sieve = phase_sieve(args.seed, proxies)
    log(f"[3] sieve on both rings: {time.time() - t0:.1f} s")
    prof = phase_profile(args.seed, proxies)
    t0 = time.time()
    phase_card_vs_cpu(args.seed, proxies)
    log(f"[4] card vs CPU: {time.time() - t0:.1f} s")
    errs = phase_clear_vs_mpc(proxies, sieve)
    t0 = time.time()
    tgt = phase_target(args.seed, smi)
    log(f"[6a] target phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    csieve = phase_clear_sieve(args.seed, proxies, sieve, smi)
    log(f"[6b] clear sieve phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    serving = phase_serve(args.seed, smi)
    log(f"[7] token serving phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    zoo = phase_zoo_serve(args.seed, smi)
    log(f"[7b] zoo serving phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    pipeline = phase_selection(args.seed, smi)
    log(f"[8] run_selection phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    variants = phase_variants(args.seed, proxies, smi)
    log(f"[9a] exact-op variants: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_variants_card_vs_cpu(args.seed)
    log(f"[9b] card vs CPU: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_mirror(proxies)
    log(f"[9c] mirror: {time.time() - t0:.1f} s")
    t0 = time.time()
    selected = phase_select(args.seed, smi)
    log(f"[9d] launch.select: {time.time() - t0:.1f} s")
    t0 = time.time()
    service = phase_service(args.seed, smi, pipeline)
    log(f"[10] appraisal service: {time.time() - t0:.1f} s")
    t0 = time.time()
    protos = phase_protocols(args.seed, proxies, smi)
    log(f"[11a] protocol backends: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_protocols_card_vs_cpu(args.seed)
    log(f"[11b] card vs CPU: {time.time() - t0:.1f} s")
    t0 = time.time()
    mal = phase_malicious(args.seed, proxies, smi)
    log(f"[11c] malicious tier: {time.time() - t0:.1f} s")
    t0 = time.time()
    wire = phase_wire(args.seed, proxies, smi)
    log(f"[12a-d] real wire: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_wire_card_vs_cpu(args.seed)
    log(f"[12e] card vs CPU tapes: {time.time() - t0:.1f} s")
    t0 = time.time()
    trained = phase_train(args.seed, smi)
    log(f"[13] training: {time.time() - t0:.1f} s")
    tl = trained["launches"]

    dl, l8, l10 = selected["launches"], pipeline["launches"], \
        service["launches"]
    by_path = {name: {"3": sieve["launches"][name], "8": l8[short],
                      "9a": variants["launches"][name], "9d": dl[short],
                      "10": l10[short]}
               for name, short in (("ring_matmul", "rmm"),
                                   ("secure_matmul", "smm"))}
    by_path["ring_matmul"]["11"] = protos["launches"]["ring_matmul"] \
        + mal["launches"]["ring_matmul"]
    for name in by_path:
        by_path[name]["12"] = wire["launches"][name]
    kernels = []
    for name, tpu in (("ring_matmul", RING_MATMUL_TPU),
                      ("secure_matmul", SECURE_MATMUL_TPU)):
        k32, k64 = kern[name]["int32"], kern[name]["int64"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
            "replaces": tpu,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(k32["max_abs_err"], k64["max_abs_err"]),
            "ms": k32["ms"], "plain_ms": k32["plain_ms"],
            "bound_ms": k32["bound_ms"], "bound_by": k32["bound_by"],
            "library_ms": None,
            "library_note": f"torch has no CUDA int32/int64 matmul "
                            f"({kern['library_error']})",
            "shape": k32["shape"], "dtype": "int32", "int64": k64})
        for x in ("device_ms", "cuda_core_bound_ms", "bound_share"):
            kernels[-1][x] = k32[x]
        if name == "ring_matmul":
            kernels[-1]["cases"] = kern["ring_matmul_cases"]
            kernels[-1]["sass"] = rmm_sass
        else:
            for x in ("unfused_ms", "unfused_device_ms"):
                kernels[-1][x] = k32[x]
            kernels[-1]["sass"] = smm_sass
            kernels[-1]["ring32_wave_ms"] = \
                prof["ring32"]["secure_matmul_ms"]
    rg = serving["recurrentgemma_2b"]["launches"]
    fwd_by_path = {
        "flash_attn": {"6a": tgt["launches"]["flash_attn"]["kernel"],
                       "7 recurrentgemma_2b": rg["flash_attn"]["kernel"],
                       "7b": zoo["launches"],
                       "8": l8["fa"], "9d": dl["fa"], "10": l10["fa"],
                       "13": tl["fa"]},
        "entropy_head": {"6a": tgt["launches"]["entropy_head"]["kernel"],
                         "8": l8["eh"], "9d": dl["eh"], "10": l10["eh"]},
        "mlp_softmax_attn": {
            "6b": csieve["launches"]["mlp_softmax_attn"]["kernel"],
            "8": l8["msa"], "9d": dl["msa"], "10": l10["msa"]}}
    launches = {
        **{name: sum(p.values()) for name, p in fwd_by_path.items()},
        "ssd": serving["mamba2_2_7b"]["launches"]["ssd"]["kernel"],
        "rg_lru": rg["rg_lru"]["kernel"]}
    tpu = {"flash_attn": FLASH_ATTN_TPU, "entropy_head": ENTROPY_HEAD_TPU,
           "mlp_softmax_attn": MLP_SOFTMAX_ATTN_TPU, "ssd": SSD_TPU,
           "rg_lru": RG_LRU_TPU}
    notes = {"flash_attn": "torch.nn.functional.scaled_dot_product_attention",
             "ssd": "none: no single torch call computes the chunked SSD "
                    "scan",
             "rg_lru": "none: no single torch call computes a linear "
                       "recurrence",
             "entropy_head": "torch.distributions.Categorical(logits=x, "
                             "validate_args=False).entropy(), a yardstick "
                             "timed here, never on the path"}
    measured = {**fkern, **skern}
    for name in ("flash_attn", "entropy_head", "mlp_softmax_attn", "ssd",
                 "rg_lru"):
        k = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
            "replaces": tpu[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "library_note": notes.get(
                name, "no single torch call computes this function"),
            "shape": k["shape"],
            **{x: k[x] for x in ("bf16_max_abs_err", "vocab", "dh256",
                                 "prefix", "cross",
                                 "f32", "cuda_core_bound_ms",
                                 "bound_share", "device_ms",
                                 "library_device_ms", "device_bound_share",
                                 "rotating_device_ms",
                                 "rotating_device_bound_share",
                                 "old_ops_bound_ms", "phase1",
                                 "bitwise_repeat", "plain_device_ms",
                                 "plan")
               if x in k}})
        if name == "ssd":
            kernels[-1]["sass"] = ssd_sass
        if name in fwd_by_path:
            kernels[-1]["launches_by_path"] = fwd_by_path[name]
        if name == "entropy_head":
            kernels[-1]["build"] = eh_build
        if name == "rg_lru":
            kernels[-1]["build"] = lru_build
            kernels[-1]["prefill_batch_kernel_ms"] = serving[
                "recurrentgemma_2b"]["profile"]["kernels"]["rg_lru"]["ms"]
        if name == "mlp_softmax_attn":
            kernels[-1]["build"] = msa_build
            kernels[-1]["clear_sieve_kernel_ms"] = \
                csieve["mlp_softmax_attn_ms"]
        if name == "flash_attn":
            kernels[-1]["sass"] = fa_sass
    for name, short, src, replaces, build_info in (
            ("flash_attn_bwd", "fa_bwd", "flash_attn_bwd.cu",
             FLASH_ATTN_BWD_REPLACES, fa_bwd_build),
            ("mlp_softmax_attn_bwd", "msa_bwd", "mlp_softmax_attn_bwd.cu",
             MLP_SOFTMAX_ATTN_BWD_REPLACES, msa_bwd_build)):
        k = bkern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": replaces,
            "launches": l8[short] + dl[short] + l10[short]
            + tl.get(short, 0),
            "launches_by_path": {"8": l8[short], "9d": dl[short],
                                 "10": l10[short], "13": tl.get(short, 0)},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            "library_note": (
                "torch.nn.functional.scaled_dot_product_attention forward "
                "and backward" if name == "flash_attn_bwd" else
                "none: no single torch call computes this function"),
            "shape": k["shape"], "build": build_info,
            "launches_note": (
                "two kernels a backward call (dq, then dk/dv; at Dh 256 "
                "three: dq, the dk and dv passes in one launch, the group "
                "sum; four in float32 where the dq pass walks its keys in "
                "parts: their combine), all counted"
                if name == "flash_attn_bwd" else
                "two kernels a backward call (head pass, then head sum), "
                "both counted"),
            **{x: k[x] for x in ("bf16_max_abs_err", "device_ms",
                                 "library_device_ms",
                                 "library_fwd_device_ms",
                                 "library_bwd_device_ms", "bound_share",
                                 "cuda_core_bound_ms", "bitwise_repeat",
                                 "phase1", "bf16") if x in k}})
        if name == "flash_attn_bwd":
            kernels[-1]["dh256"] = tkern["flash_attn_bwd_dh256"]
    for name, short, replaces, build_info, note in (
            ("ssd_bwd", "ssd_bwd", SSD_BWD_REPLACES, ssd_bwd_build,
             "three kernels a backward call in either type (the state "
             "pass, the chunk pass, the sum over head groups), all "
             "counted"),
            ("rg_lru_bwd", "lru_bwd", RG_LRU_BWD_REPLACES, lru_bwd_build,
             "one kernel a backward call")):
        k = tkern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
            "replaces": replaces, "launches": tl[short],
            "launches_by_path": {"13": tl[short]},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "library_note": "none: no single torch call computes this "
                            "function",
            "shape": k["shape"], "build": build_info, "launches_note": note,
            **{x: k[x] for x in ("bf16_max_abs_err", "device_ms",
                                 "bound_share", "cuda_core_bound_ms",
                                 "bitwise_repeat", "f32") if x in k}})
    summary = {k: trained[k] for k in ("13b", "13c")}
    log(f"[13] summary: {json.dumps(summary)}")
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
