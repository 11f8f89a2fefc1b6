"""Mamba-2 SSD (state-space duality) mixer, arXiv:2405.21060 — the port
of repro/models/ssd.py.

Block: in_proj -> [z | xBC | dt]; causal conv1d + silu on xBC;
SSD core (chunked scan: intra-chunk quadratic attention-like term +
inter-chunk linear state recurrence); gated RMSNorm; out_proj.

`ssd_scan` goes through `kernels.ops.ssd_chunked`: on a CUDA tensor the
hand-written `ssd` kernel (which also writes the final state, so prefill
needs no second pass), on the CPU the plain chunked scan, op for op the
JAX function. Under grad (training) it is the `SsdScan` Function, whose
backward is the `ssd` backward kernel on the card. Single-step decode (`ssd_step`) is plain torch, as in JAX,
and carries (conv_state, ssm_state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.rglru import _causal_conv


def init_ssd_block(gen: torch.Generator, d_model: int, n_layers: int,
                   d_state: int = 128, expand: int = 2, head_dim: int = 64,
                   conv_width: int = 4, device=None):
    dev = gen.device if device is None else torch.device(device)
    d_in = expand * d_model
    n_heads = d_in // head_dim
    d_xbc = d_in + 2 * d_state
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads))
    return {
        "w_in": common.dense_init(
            gen, (n_layers, d_model, 2 * d_in + 2 * d_state + n_heads),
            device=device),
        "conv_w": common.dense_init(gen, (n_layers, conv_width, d_xbc),
                                    device=device) * 0.1,
        "conv_b": torch.zeros((n_layers, d_xbc), device=dev),
        "a_log": a_log[None].repeat(n_layers, 1).to(dev),
        "dt_bias": torch.zeros((n_layers, n_heads), device=dev),
        "d_skip": torch.ones((n_layers, n_heads), device=dev),
        "norm_scale": torch.zeros((n_layers, d_in), device=dev),
        "w_out": common.dense_init(gen, (n_layers, d_in, d_model), in_axis=-2,
                                   device=device),
    }


def ssd_scan(x, a, b, c, chunk: int = 128, state0=None):
    """Chunked SSD.

    x: (B, T, H, P) inputs (already dt-scaled), a: (B, T, H) log decays,
    b, c: (B, T, N) in/out state projections (n_groups=1, shared by heads).
    Returns y: (B, T, H, P), final state (B, H, P, N).
    """
    t = x.shape[1]
    assert t % min(chunk, t) == 0
    return kops.ssd_chunked(x, a.float(), b, c, chunk=chunk, state0=state0)


def ssd_step(x, a, b, c, state):
    """One decode step. x: (B, 1, H, P); a: (B, 1, H); b/c: (B, 1, N)."""
    a_ = torch.exp(a[:, 0].float())                             # (B,H)
    contrib = torch.einsum("bn,bhp->bhpn", b[:, 0].float(), x[:, 0].float())
    state = state * a_[..., None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), state)
    return y[:, None].to(x.dtype), state


def ssd_block(x, p, cfg, state=None, decode: bool = False):
    """Full Mamba-2 block. state = (conv_state, ssm_state)."""
    d_model = x.shape[-1]
    d_in = cfg.ssm_expand * d_model
    hd = cfg.ssm_head_dim
    n_heads = d_in // hd
    n_state = cfg.ssm_state

    proj = torch.einsum("btd,dk->btk", x, p["w_in"].to(x.dtype))
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * n_state, n_heads],
                             dim=-1)
    conv_state = state[0] if state is not None else None
    xbc, conv_state_new = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                       p["conv_b"].to(x.dtype), conv_state)
    xbc = F.silu(xbc)
    xi, b, c = torch.split(xbc, [d_in, n_state, n_state], dim=-1)
    xh = xi.reshape(*xi.shape[:2], n_heads, hd)

    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,T,H)
    a_neg = -torch.exp(p["a_log"].float())                       # (H,)
    log_decay = dt * a_neg                                       # (B,T,H)
    x_in = xh * dt[..., None].to(xh.dtype)

    ssm_state = state[1] if state is not None else None
    if decode:
        y, ssm_new = ssd_step(x_in, log_decay, b, c, ssm_state)
    else:
        y, ssm_new = ssd_scan(x_in, log_decay, b, c, state0=ssm_state)
    y = y + xh * p["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(*x.shape[:2], d_in)
    y = common.rmsnorm(y * F.silu(z), p["norm_scale"])
    return torch.einsum("bti,id->btd", y, p["w_out"].to(x.dtype)), \
        (conv_state_new, ssm_new)


def init_ssd_state(batch: int, d_model: int, cfg, dtype=torch.bfloat16,
                   device=None):
    d_in = cfg.ssm_expand * d_model
    n_heads = d_in // cfg.ssm_head_dim
    d_xbc = d_in + 2 * cfg.ssm_state
    return (torch.zeros((batch, cfg.conv_width - 1, d_xbc), dtype=dtype,
                        device=device),
            torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device))
