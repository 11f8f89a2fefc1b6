"""Shared building blocks: norms, RoPE, activations, init, masks — the
port of repro/models/common.py.

Initializers draw from a `torch.Generator` (so their values differ from
JAX's for the same seed; tests carry JAX weights across instead). The
rest matches the JAX functions op for op, with two conventions to keep:
`act_fn("gelu")` is the tanh approximation (jax.nn.gelu's default, not
torch's), and `apply_rope` rotates interleaved pairs (0::2, 1::2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _draw_device(gen: torch.Generator, device):
    return gen.device, (gen.device if device is None else torch.device(device))


def truncated_normal(gen: torch.Generator, shape, device=None):
    """Standard normal truncated to [-2, 2], by the inverse CDF as
    jax.random.truncated_normal draws it: drawn on the generator's
    device, returned on `device` (default: the generator's)."""
    src, dst = _draw_device(gen, device)
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(tuple(shape), generator=gen, device=src)
    x = math.sqrt(2) * torch.erfinv(lo + u * (hi - lo))
    return x.clamp(-2.0, 2.0).to(dst)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2, device=None):
    return truncated_normal(gen, shape, device) / math.sqrt(shape[in_axis])


def embed_init(gen: torch.Generator, shape, device=None):
    src, dst = _draw_device(gen, device)
    return (torch.randn(tuple(shape), generator=gen, device=src) * 0.02) \
        .to(dst)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(dt)


def apply_norm(x, p, norm_type: str):
    if norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(d: int, norm_type: str, device=None):
    if norm_type == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.zeros(d, device=device)}   # rmsnorm: a delta


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, fraction: float = 1.0,
               device=None):
    d_rot = int(d_head * fraction) // 2 * 2
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_rot)), d_rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (..., seq, heads, d_head); positions: (..., seq)."""
    d_head = x.shape[-1]
    inv, d_rot = rope_freqs(d_head, theta, fraction, x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, d_rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xr = x[..., :d_rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    rot = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    if d_rot == d_head:
        return rot
    return torch.cat([rot, x[..., d_rot:]], dim=-1)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": _gelu_tanh, "relu": torch.relu, "silu": F.silu,
            "gelu_tanh": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# masks (boolean predicates on (q_pos, k_pos))
# ---------------------------------------------------------------------------

def mask_fn(kind: str, window: int = 0, prefix_len: int = 0):
    """Returns pred(q_pos, k_pos) -> bool allowed. Positions are absolute."""
    if kind == "causal":
        return lambda q, k: k <= q
    if kind == "local":
        return lambda q, k: (k <= q) & (k > q - window)
    if kind == "bidir":
        return lambda q, k: torch.ones(
            torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
            device=q.device)
    if kind == "prefix":
        return lambda q, k: (k <= q) | (k < prefix_len)
    raise ValueError(kind)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token cross-entropy in fp32; labels == ignore_id masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp(min=0).long()
    ll = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)
