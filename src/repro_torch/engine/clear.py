"""ClearEngine — float interpretation of the proxy forward.

The numerical reference the MPC forward is held against. Nonlinearity
strategies implement the Table-2 ablations (exact softmax / rsqrt /
entropy when the MLP emulator is ablated) and the Table-3 baseline
softmaxes (MPCFormer 2Quad, Bolt-style polynomial exp).

On the card two of them run on hand-written kernels that compute the
same functions without materializing what the CPU path does:
`attend` with the MLP_sm emulator ("sm") launches `mlp_softmax_attn`
(no S x S probabilities; probs @ V reassociated, so allclose to the
CPU path, not bitwise), and the exact entropy (variants without "se")
launches `entropy_head`, whose m + log z - s/z differs from
`softmax_entropy`'s -sum p log(p + 1e-9) by at most V * 1e-9 plus
rounding. On the CPU both stay the materialized sequence the JAX
package's ClearEngine runs.
"""
import contextlib
import dataclasses
from typing import ClassVar

import torch

from repro_torch.engine.forward import _mlp_at, attend_materialized
from repro_torch.kernels import ops as kops


def mlp_apply(p, x):
    """Clear 2-layer emulator MLP (Linear -> ReLU -> Linear)."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def softmax_entropy(logits):
    """Exact fused softmax+entropy (the op MLP_se emulates)."""
    p = torch.softmax(logits, dim=-1)
    return -torch.sum(p * torch.log(p + 1e-9), dim=-1, keepdim=True)


def mlp_attend(p, qT, kT, v):
    """MLP_sm attention through `kernels.ops.mlp_softmax_attn`: the heads
    fold into the kernel's batch, and k / v stay one row per kv head
    (read per group, not broadcast). Same shapes as `ClearEngine.attend`."""
    b, wk, g, s, dh = qT.shape
    q = qT.reshape(b * wk * g, s, dh)
    k = kT[:, :, 0].transpose(-1, -2).reshape(b * wk, s, dh)
    vv = v.reshape(b, s, wk, dh).movedim(2, 1).reshape(b * wk, s, dh)
    o = kops.mlp_softmax_attn(q, k, vv, p["w1"], p["b1"], p["w2"], p["b2"])
    return o.reshape(b, wk, g, s, dh)


@dataclasses.dataclass(frozen=True)
class ClearEngine:
    """Stateless float engine."""

    variant: frozenset | None = None     # default nonlinearity policy
    kind: ClassVar[str] = "clear"

    # -- data entry ------------------------------------------------------
    def embed(self, pp, x_in, cfg):
        if torch.is_floating_point(x_in):
            return x_in                  # pre-embedded activations
        x = pp["embed"][x_in].to(torch.float32)
        return x * float(torch.tensor(cfg.d_model ** 0.5,
                                      dtype=torch.float32))

    # -- round compression (no wire: nothing to fuse) --------------------
    def fused(self, label):
        return contextlib.nullcontext()

    # -- linear algebra --------------------------------------------------
    def add(self, x, y):
        return x + y

    def sub(self, x, y):
        return x - y

    def mul(self, x, y):
        return x * y

    def mul_public(self, x, v):
        return x * v

    def add_public(self, x, v):
        return x + v

    def matmul(self, x, y):
        return torch.matmul(x, y)

    def mean(self, x, axis):
        return torch.mean(x, dim=axis)

    # -- shape ops -------------------------------------------------------
    def shape(self, x):
        return tuple(x.shape)

    def reshape(self, x, shape):
        return torch.reshape(x, tuple(shape))

    def broadcast(self, x, shape):
        return torch.broadcast_to(x, tuple(shape))

    def moveaxis(self, x, src, dst):
        return torch.movedim(x, src, dst)

    def swapaxes(self, x, a, b):
        return torch.swapaxes(x, a, b)

    def index(self, x, i):
        return x[i]

    # -- nonlinearity strategies -----------------------------------------
    def mlp(self, p, x):
        return mlp_apply(p, x)

    def ln_inv(self, pp, li, var, variant):
        if "ln" in variant:
            return self.mlp(_mlp_at(pp["mlp_ln"], li), var)
        return torch.rsqrt(var + 1e-5)

    def attn_probs(self, pp, li, scores, variant):
        """Rows (N, S) -> attention probabilities (N, S)."""
        if "sm" in variant:
            return self.mlp(_mlp_at(pp["mlp_sm"], li), scores)
        if "quad_sm" in variant:         # MPCFormer 2Quad
            e = (scores + 5.0) ** 2
            return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-6)
        if "poly_sm" in variant:         # Bolt-style polynomial exp
            t = torch.clamp(scores - scores.amax(-1, keepdim=True), -8, 0)
            e = 1 + t + t * t / 2 + t ** 3 / 6 + t ** 4 / 24
            e = torch.clamp(e, min=0.0)
            return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-6)
        return torch.softmax(scores, dim=-1)

    def attend(self, pp, li, qT, kT, v, variant):
        """qT (b, wk, g, s, dh), kT (b, wk, g, dh, s), v (b * s, wk * dh)
        -> attention output (b, wk, g, s, dh)."""
        if "sm" in variant and qT.is_cuda:
            return mlp_attend(_mlp_at(pp["mlp_sm"], li), qT, kT, v)
        return attend_materialized(self, pp, li, qT, kT, v, variant)

    def entropy_head(self, pp, logits, variant):
        if "se" in variant:
            return self.mlp(pp["mlp_se"], logits)[:, 0]
        if logits.is_cuda:
            return kops.entropy_head(logits)
        return softmax_entropy(logits)[:, 0]
