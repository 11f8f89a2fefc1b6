"""MLP emulators for fused nonlinear operators (paper §4.3).

Each emulator is a 2-layer MLP (Linear -> ReLU -> Linear) substituting a
*group* of nonlinear ops while reducing the dimension the nonlinearity is
evaluated at:

  MLP_sm  softmax over attention scores:   R^S -> R^h -> R^S  (h = 2..16)
  MLP_ln  rsqrt(var + eps) in LayerNorm:   R^1 -> R^h -> R^1
  MLP_se  softmax(logits) + entropy fused: R^C -> R^h -> R^1

Only the initializer is ported so far; ex-vivo fitting is training and
belongs to a later slice. The apply paths live in the engine layer
(`engine/clear.mlp_apply`, `engine/mpc.mlp_apply_mpc`).
"""
from __future__ import annotations

import torch


def init_mlp(gen: torch.Generator, d_in: int, hidden: int, d_out: int,
             device=None):
    """Random emulator weights (the JAX package's init scales; torch's
    normals, so the values differ from JAX's for the same seed)."""
    s1 = (2.0 / (d_in + hidden)) ** 0.5
    s2 = (2.0 / (hidden + d_out)) ** 0.5

    def nrm(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    p = {"w1": nrm(d_in, hidden) * s1,
         "b1": torch.zeros(hidden),
         "w2": nrm(hidden, d_out) * s2,
         "b2": torch.zeros(d_out)}
    return {k: v.to(device) for k, v in p.items()}
