"""Dense FFN (GLU or plain MLP) — the port of repro/models/ffn.py's
dense half. The top-k MoE is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common


def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int, act: str,
                   n_layers: int, device=None):
    glu = act in ("swiglu", "geglu")
    wi_out = 2 * d_ff if glu else d_ff
    return {
        "wi": common.dense_init(gen, (n_layers, d_model, wi_out),
                                device=device),
        "wo": common.dense_init(gen, (n_layers, d_ff, d_model), in_axis=-2,
                                device=device),
    }


def dense_ffn(x, p, act: str):
    """x: (B, T, d); p per-layer slice {wi, wo}."""
    h = torch.einsum("btd,df->btf", x, p["wi"].to(x.dtype))
    if act in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        fn = F.silu if act == "swiglu" else common.act_fn("gelu")
        h = fn(g) * u
    else:
        h = common.act_fn(act)(h)
    return torch.einsum("btf,fd->btd", h, p["wo"].to(x.dtype))
