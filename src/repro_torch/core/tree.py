"""Parameter trees: nested dicts and lists with tensor leaves (the port's
stand-in for JAX pytrees)."""
from __future__ import annotations

import numpy as np
import torch


def to_device(tree, device="cuda"):
    """A tree of numpy arrays (or JAX arrays, or tensors) as the port's
    tree of tensors on `device` — how weights built by the JAX package,
    or by the port on another device, are carried across."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.array(tree)).to(device)


def tree_leaves(tree) -> list:
    """Leaves in JAX's pytree order (dict keys sorted, lists in order) —
    the order the share keys are split in, so shares match bitwise."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `tree_leaves` order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [go(v) for v in t]
        return next(it)

    return go(tree)
