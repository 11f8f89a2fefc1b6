"""AdamW with global-norm clipping + cosine schedule — the port of
repro/optim/adamw.py, over the port's parameter trees (nested dicts of
tensors, `core.tree`).

State mirrors params: m and v in float32, and a 0-d int32 step, as in
JAX. Departure: the update is in place (params, m and v are written
through, and the same trees are returned), so a step at full width
holds one copy of each instead of two; the values are JAX's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.tree import tree_leaves, tree_rebuild


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to cfg.lr, then a cosine decay to a tenth of it, in
    float32: a 0-d tensor on `step`'s device (the CPU for a number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog.clamp(0, 1)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def init_opt_state(params) -> dict:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros():
        return tree_rebuild(params, [torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
                                     for p in leaves])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in float32."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step: (params, state, {"grad_norm", "lr"}), the gradients
    clipped to global norm cfg.clip_norm, weight decay on every leaf.
    params, state["m"] and state["v"] are updated in place."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    lr = cosine_schedule(cfg, t)
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                    device=t.device), t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.float()
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"grad_norm": gn, "lr": lr}
