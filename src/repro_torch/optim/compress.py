"""Gradient compression for the DP all-reduce — the port of
repro/optim/compress.py, over the port's parameter trees.

  top-k + error feedback (Lin et al., Deep Gradient Compression): keep
  the k largest-|g| entries per tensor, accumulate the residual locally.
  Ties break to the lower flat index, as `jax.lax.top_k` breaks them
  (a stable descending sort).

  int8 stochastic quantization: per-tensor scale, stochastic rounding,
  dequant after the all-reduce (simulated). The noise is drawn with the
  port's threefry (`mpc.prng`), so for the same key the result is
  bitwise the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_rebuild
from repro_torch.mpc import prng


def _topk_one(g, e, ratio: float):
    g = g.float() + e
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    kept = flat * mask
    return kept.reshape(g.shape), (flat - kept).reshape(g.shape)


def topk_compress_update(grads, errors, ratio: float = 0.01):
    """Returns (sparse_grads, new_errors). sparse has zeros off-support."""
    outs = [_topk_one(g, e, ratio)
            for g, e in zip(tree_leaves(grads), tree_leaves(errors))]
    return (tree_rebuild(grads, [o[0] for o in outs]),
            tree_rebuild(grads, [o[1] for o in outs]))


def init_error_state(params):
    return tree_rebuild(params, [torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                                 for p in tree_leaves(params)])


def int8_allreduce_sim(grads, key: torch.Tensor):
    """Quantize->dequantize round trip (what the int8 collective carries).
    `key` is a threefry key (`mpc.prng.key`), split once per leaf in
    tree order, as `jax.random.split` is."""
    leaves = tree_leaves(grads)
    keys = prng.split(key, len(leaves))
    out = []
    for i, g in enumerate(leaves):
        g = g.float()
        scale = torch.clamp(g.abs().max(), min=1e-9) / 127.0
        noise = prng.uniform(keys[i].to(g.device), g.shape, -0.5, 0.5)
        q = torch.clamp(torch.round(g / scale + noise), -127, 127) \
            .to(torch.int8)
        out.append(q.float() * scale)
    return tree_rebuild(grads, out)


def wire_bytes(grads, scheme: str, ratio: float = 0.01) -> int:
    n = sum(int(x.numel()) for x in tree_leaves(grads))
    if scheme == "topk":
        return int(n * ratio) * 8            # value + index
    if scheme == "int8":
        return n
    return n * 4
