#!/usr/bin/env python3
"""Time phase 8a's clear run of one checkout of this repository, stage by
stage, on one NVIDIA GPU:

    python3 tools/selection_ab.py --tree DIR [--seed 0]

DIR is the root of a checkout (this one by default); its chip_smoke.py
and src/ are imported and its kernels built from its own sources. The
run is chip_smoke.py phase 8a's first half: `run_selection` in
mode="clear" with a random BERT-base target at full size, a pool of 64
at seq 512 (8 bootstrap rows, a budget of 13), `two_phase_default(12)`,
SelectionConfig's step counts with the ex-vivo fits cut as chip_smoke
cuts them (A_STEPS). It prints the card's name and power limit and one
JSON line: the run's wall and each stage's wall (host clock ending in a
synchronize) with its launches of the attention kernels, forward and
backward. To compare two trees, run it in one call on one card, in
turns (A, B, B, A); the stages are host-bound, so read the spread of the
stages the change does not touch beside the one it does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("selection_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke as cs
    from repro_torch.configs.paper_targets import BERT
    from repro_torch.core import target
    from repro_torch.data.tasks import make_classification_task
    from repro_torch.kernels import build
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = make_classification_task(
        args.seed + cs.SEL_SEED_OFFSET, n_pool=cs.SEL_POOL, n_test=8,
        seq=cs.SEQ, vocab=BERT.vocab_size, n_classes=cs.CLASSES)
    params = target.init_classifier(
        torch.Generator(device="cuda").manual_seed(
            args.seed + cs.SEL_SEED_OFFSET), BERT, cs.CLASSES,
        device="cuda")
    _, stages, _, wall, _ = cs._run_selection(
        args.seed, params, task.pool_tokens, task.pool_labels, "clear",
        None, steps=cs.A_STEPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"tree": tree, "wall_s": wall, "stages": [
        {"stage": r["stage"], "wall_s": r["wall_s"],
         "launches": {n: r["launches"].get(n) for n in ("fa", "fa_bwd")}}
        for r in stages]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
