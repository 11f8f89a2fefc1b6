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


def trainable(tree):
    """(a copy of `tree` whose leaves are fresh float leaf tensors that
    require grad, those leaves in `tree_leaves` order)."""
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(tree)]
    return tree_rebuild(tree, leaves), leaves


def detached(tree):
    """`tree` with every leaf detached from autograd (what training hands
    back, as JAX returns plain arrays)."""
    return tree_rebuild(tree, [x.detach() for x in tree_leaves(tree)])


def grads(loss, leaves) -> tuple:
    """d loss / d leaf for every leaf, zeros for leaves the loss does not
    use (as jax.grad gives them)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def adam_step(leaves, grads, m, v, i: int, lr: float) -> None:
    """One plain Adam update in place, as the JAX package's training
    loops write it: m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g^2, the bias
    corrections 1 - 0.9 ** (i + 1) and 1 - 0.999 ** (i + 1) in float32
    (JAX takes the power of jnp.float32(i)), then
    p -= lr * m_hat / (sqrt(v_hat) + 1e-8). `m` and `v` are lists of
    zero-initialised tensors beside `leaves`."""
    f32 = torch.float32
    t = torch.tensor(i + 1.0, dtype=f32)
    c1 = float(1 - torch.tensor(0.9, dtype=f32) ** t)
    c2 = float(1 - torch.tensor(0.999, dtype=f32) ** t)
    with torch.no_grad():
        for p, g, m_, v_ in zip(leaves, grads, m, v):
            m_.copy_(0.9 * m_ + 0.1 * g)
            v_.copy_(0.999 * v_ + 0.001 * g * g)
            p.sub_(lr * (m_ / c1) / (torch.sqrt(v_ / c2) + 1e-8))
