"""Griffin RG-LRU recurrent block (RecurrentGemma), arXiv:2402.19427 —
the port of repro/models/rglru.py.

Block:  x -> [branch1: linear -> causal conv1d(w=4) -> RG-LRU]
             [branch2: linear -> GeLU]
        out = linear(branch1 * branch2)

RG-LRU recurrence (diagonal, gated):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * r_t * softplus(Lambda)        (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill computes the gates in torch and the recurrence with
`kernels.ops.rg_lru_scan`: the hand-written `rg_lru` kernel on a CUDA
tensor, a plain serial scan on the CPU (the JAX package runs an
associative scan, so the two agree to rounding, not bitwise). Under grad
(training) the recurrence is the `RgLru` Function, whose backward is the
`rg_lru` backward kernel on the card. Decode is a single step in plain
torch, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import common

C_GATE = 8.0


def init_rglru_block(gen: torch.Generator, d_model: int, lru_width: int,
                     n_layers: int, conv_width: int = 4, device=None):
    dev = gen.device if device is None else torch.device(device)
    lam = torch.log(torch.expm1(torch.linspace(2.0, 6.0, lru_width)))
    return {
        "w_in": common.dense_init(gen, (n_layers, d_model, lru_width),
                                  device=device),
        "w_gate_br": common.dense_init(gen, (n_layers, d_model, lru_width),
                                       device=device),
        "conv_w": common.dense_init(gen, (n_layers, conv_width, lru_width),
                                    device=device) * 0.1,
        "conv_b": torch.zeros((n_layers, lru_width), device=dev),
        "w_a": common.dense_init(gen, (n_layers, lru_width, lru_width),
                                 device=device),
        "b_a": torch.zeros((n_layers, lru_width), device=dev),
        "w_x": common.dense_init(gen, (n_layers, lru_width, lru_width),
                                 device=device),
        "b_x": torch.zeros((n_layers, lru_width), device=dev),
        # Lambda init so a^c in [0.9, 0.999] (Griffin's init)
        "lam": lam[None].repeat(n_layers, 1).to(dev),
        "w_out": common.dense_init(gen, (n_layers, lru_width, d_model),
                                   in_axis=-2, device=device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, T, C), w: (W, C). Returns y, new_state."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return y + b, new_state


def _rglru_gates(u, p):
    """u: (B, T, lru). Returns (a, bterm) of the recurrence h = a h- + b."""
    r = torch.sigmoid(torch.einsum("btl,lm->btm", u, p["w_a"].to(u.dtype))
                      + p["b_a"].to(u.dtype))
    i = torch.sigmoid(torch.einsum("btl,lm->btm", u, p["w_x"].to(u.dtype))
                      + p["b_x"].to(u.dtype))
    log_a = -C_GATE * r.float() * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    bterm = mult * (i.float() * u.float())
    return a, bterm


def rglru_scan(u, p, h0=None):
    """The recurrence over time. u: (B, T, lru) -> (y, h_last)."""
    a, bterm = _rglru_gates(u, p)
    if h0 is not None:
        # fold initial state into the first step
        bterm = bterm.clone()
        bterm[:, 0] += a[:, 0] * h0
    h = kops.rg_lru_scan(a, bterm)
    return h.to(u.dtype), h[:, -1]


def rglru_step(u, p, h):
    """Single decode step. u: (B, 1, lru), h: (B, lru)."""
    a, bterm = _rglru_gates(u, p)
    h_new = a[:, 0] * h + bterm[:, 0]
    return h_new[:, None].to(u.dtype), h_new


def rglru_block(x, p, state=None, decode: bool = False):
    """Full Griffin recurrent block. state = (conv_state, h)."""
    u = torch.einsum("btd,dl->btl", x, p["w_in"].to(x.dtype))
    gate = common.act_fn("gelu")(
        torch.einsum("btd,dl->btl", x, p["w_gate_br"].to(x.dtype)))
    conv_state = state[0] if state is not None else None
    h0 = state[1] if state is not None else None
    u, conv_state_new = _causal_conv(u, p["conv_w"].to(x.dtype),
                                     p["conv_b"].to(x.dtype), conv_state)
    if decode:
        y, h_new = rglru_step(u, p, h0)
    else:
        y, h_new = rglru_scan(u, p, h0)
    out = torch.einsum("btl,ld->btd", y * gate, p["w_out"].to(x.dtype))
    return out, (conv_state_new, h_new)


def init_rglru_state(batch: int, lru_width: int, conv_width: int = 4,
                     dtype=torch.bfloat16, device=None):
    return (torch.zeros((batch, conv_width - 1, lru_width), dtype=dtype,
                        device=device),
            torch.zeros((batch, lru_width), dtype=torch.float32,
                        device=device))
