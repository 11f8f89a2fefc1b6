"""Training driver: data pipeline + train step + checkpoint/restart +
fault-tolerance hooks — the port of repro/launch/train.py, on one card.

    python -m repro_torch.launch.train --arch qwen2_0_5b --full
    python -m repro_torch.launch.train --device cpu     # smoke size

The loop structure is the JAX package's: deterministic resume (the data
state is (seed, step), so a restarted run replays the same batches),
async checkpoints through `checkpoint.AsyncCheckpointer`, a heartbeat
and a straggler-mitigated input pipeline. The step is `models.
transformer.train_loss` under autograd, its forward and backward on the
card's kernels (flash_attn, ssd, rg_lru, each with its backward kernel),
then `optim.adamw_update` in place. The JAX package's device mesh and
sharding rules are the identity on one card: `model_parallel` other
than 1 raises (ROADMAP Queue 1 item 14, multi-device), and the moe
family routes in one group, JAX's `data_shards` of a one-device mesh.
The vlm and encdec families need stub `patches` / `frames` beside the
tokens, which the data pipeline does not make: `make_train_step` takes
such batches, `train` does not, as in JAX.

Checkpoints go to `default_ckpt_dir(arch, smoke)` unless a directory is
given: one directory per configuration under the temporary directory
(`TMPDIR`), apart from the JAX package's. `train` refuses a directory
whose checkpoints do not restore into its configuration (another leaf
count, shape or dtype) rather than resume from them or write over them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                   restore_checkpoint)
from repro_torch.configs.base import ARCH_IDS, load_arch
from repro_torch.core.tree import to_device, tree_leaves, tree_rebuild
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.ft import HeartbeatMonitor, StragglerMitigator


@dataclasses.dataclass
class TrainConfig:
    arch: str = "qwen2_0_5b"
    smoke: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: str | None = None       # None: default_ckpt_dir(arch, smoke)
    ckpt_every: int = 20
    model_parallel: int = 1
    seed: int = 0
    log_every: int = 10
    remat: bool = True
    device: str = "cuda"


def default_ckpt_dir(arch: str, smoke: bool) -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt",
                        f"{arch}_{'smoke' if smoke else 'full'}")


def _restore(ckpt_dir: str, tree_like) -> tuple[dict, int | None]:
    """The newest checkpoint in `ckpt_dir` restored into `tree_like`'s
    structure, or (tree_like, None) with none there; raises if the
    directory's checkpoints are of another configuration."""
    restored, step = restore_checkpoint(ckpt_dir, tree_like)
    if step is None:
        found = latest_step(ckpt_dir)
        if found is not None:
            raise ValueError(
                f"{ckpt_dir} holds step {found}, which does not restore "
                "into this configuration (another leaf count, or corrupt)")
        return tree_like, None
    for i, (got, want) in enumerate(zip(tree_leaves(restored),
                                        tree_leaves(tree_like))):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"{ckpt_dir} step {step}: leaf {i} is {got.dtype} "
                f"{tuple(got.shape)}, this configuration's {want.dtype} "
                f"{tuple(want.shape)}")
    return restored, step


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm): the loss's gradient with respect to every parameter leaf
    (zeros where it uses none, as jax.grad gives them), then one AdamW
    step in place. The batch's arrays may be numpy or tensors."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, _ = T.train_loss(params, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        params, opt_state, stats = adamw_update(
            params, tree_rebuild(params, list(grads)), opt_state, opt_cfg)
        return params, opt_state, loss.detach(), stats["grad_norm"]
    return train_step


def train(tc: TrainConfig) -> dict:
    if tc.model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={tc.model_parallel}: training across devices "
            "is not ported yet (ROADMAP Queue 1 item 14)")
    cfg = load_arch(tc.arch, smoke=tc.smoke)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_groups=1)
    opt_cfg = AdamWConfig(total_steps=tc.steps,
                          warmup_steps=max(tc.steps // 10, 1))
    dev = torch.device(tc.device)
    ckpt_dir = tc.ckpt_dir or default_ckpt_dir(tc.arch, tc.smoke)

    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    params = T.init_params(gen, cfg, dev)
    opt_state = init_opt_state(params)

    # ---- restore --------------------------------------------------------
    start_step = 0
    t0 = time.time()
    restored, step_found = _restore(ckpt_dir,
                                    {"params": params, "opt": opt_state})
    if step_found is not None:
        restored = to_device(restored, dev)
        params, opt_state = restored["params"], restored["opt"]
        start_step = step_found
        print(f"[train] resumed from step {start_step}")
    restore_s = time.time() - t0

    step_fn = make_train_step(cfg, opt_cfg, tc.remat)
    pipe = DataPipeline(tc.seed, tc.batch, tc.seq, cfg.vocab_size,
                        start_step=start_step)
    ckpt = AsyncCheckpointer(ckpt_dir)
    hb = HeartbeatMonitor(n_hosts=1, timeout_s=60)
    strag = StragglerMitigator()
    losses, step_s, ckpt_s = [], [], 0.0
    t0 = time.time()
    try:
        for step in range(start_step, tc.steps):
            ts = time.time()
            batch_np = strag.run(lambda: next(pipe),
                                 backup=lambda: next(pipe))
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch_np.items()}
            params, opt_state, loss, gnorm = step_fn(params, opt_state,
                                                     batch)
            hb.beat(0)
            losses.append(float(loss))
            step_s.append(time.time() - ts)
            if (step + 1) % tc.log_every == 0:
                print(f"[train] step {step + 1} loss {float(loss):.4f} "
                      f"gnorm {float(gnorm):.3f} "
                      f"({(step + 1 - start_step) / (time.time() - t0):.2f}"
                      " it/s)")
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                tc0 = time.time()
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                ckpt_s += time.time() - tc0
        tc0 = time.time()
        ckpt.wait()
        ckpt_s += time.time() - tc0
    finally:
        pipe.close()
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "healthy": hb.healthy(), "backups": strag.backups_fired,
            "resumed_from": start_step, "losses": losses,
            "step_s": step_s, "ckpt_s": ckpt_s, "restore_s": restore_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full config (published widths) instead of smoke")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a directory per arch and size under "
                    "the temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(TrainConfig(arch=args.arch, smoke=not args.full,
                            steps=args.steps, batch=args.batch, seq=args.seq,
                            ckpt_dir=args.ckpt_dir, device=args.device))
    out = {k: v for k, v in out.items()
           if k not in ("losses", "step_s", "ckpt_s", "restore_s")}
    print("[train] done:", out)


if __name__ == "__main__":
    main()
