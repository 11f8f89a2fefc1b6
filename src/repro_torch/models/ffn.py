"""FFN variants: dense GLU / plain MLP, and top-k MoE — the port of
repro/models/ffn.py.

MoE dispatch is capacity-based gather/scatter, as in the JAX package:
each expert gathers its top-C tokens by router weight (priority drop
when over capacity), computes its FFN on a dense (G, E, C, d) block by
stacked-weight einsums, and the gated outputs are scattered back to
their tokens. The expert products are plain einsums in the JAX package,
outside any Pallas kernel, and stay `torch.einsum` here.

The scatter sums in a fixed order, never with atomics: each (token,
expert) pair appears at most once in an expert's top-C, so each expert's
gated rows are written into their own slot of a (G, t, E, d) buffer and
the buffer is summed over E. A token routed elsewhere that fills an
expert's spare capacity (its weight is exactly 0; which such tokens
`torch.topk` picks differs from `jax.lax.top_k` on ties) writes an exact
zero into a slot no routed pair uses, so the choice cannot change the
result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

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


def _act(h, act: str):
    if act in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        fn = F.silu if act == "swiglu" else common.act_fn("gelu")
        return fn(g) * u
    return common.act_fn(act)(h)


def dense_ffn(x, p, act: str):
    """x: (B, T, d); p per-layer slice {wi, wo}."""
    h = torch.einsum("btd,df->btf", x, p["wi"].to(x.dtype))
    return torch.einsum("btf,fd->btd", _act(h, act), p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, act: str, n_layers: int, n_shared: int = 0,
             device=None):
    glu = act in ("swiglu", "geglu")
    wi_out = 2 * d_expert if glu else d_expert
    p = {
        "router": common.dense_init(gen, (n_layers, d_model, n_experts),
                                    device=device),
        "wi": common.dense_init(gen, (n_layers, n_experts, d_model, wi_out),
                                device=device),
        "wo": common.dense_init(gen, (n_layers, n_experts, d_expert,
                                      d_model), in_axis=-2, device=device),
    }
    if n_shared:
        p["shared"] = init_dense_ffn(gen, d_model, n_shared * d_expert, act,
                                     n_layers, device)
    return p


def capacity(tl: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a group of `tl` tokens: a floor of 8 (no
    drops at decode's few tokens), else GShard's ceil(tl k / E cf),
    capped at tl."""
    cap = int(max(8, math.ceil(tl * top_k / n_experts * capacity_factor)))
    return min(cap, tl)


def capacity_topk(w_et, cap: int):
    """Each expert's top-`cap` tokens by weight: w_et (G, E, t) ->
    (weights, token indices), each (G, E, cap)."""
    return torch.topk(w_et, cap, dim=-1)


def moe_ffn(x, p, act: str, top_k: int, capacity_factor: float = 1.25,
            n_groups: int = 1):
    """x: (B, T, d). Returns (out, aux) with the load-balance stats
    {lb_loss, router_z}. Tokens are split into `n_groups` routing groups
    (one if they do not divide); routing, capacity and the gather are
    group-local, as in the JAX package."""
    b, t, d = x.shape
    e = p["router"].shape[-1]
    n_tok = b * t
    g_cnt = n_groups if n_tok % n_groups == 0 else 1
    tl = n_tok // g_cnt                                          # tokens/group
    xg = x.reshape(g_cnt, tl, d)

    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.topk(probs, top_k, dim=-1)             # (G, t, k)
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(idx_k, e).float()                         # (G,t,k,E)
    w_te = torch.einsum("gtk,gtke->gte", gate_k, onehot)

    cap = capacity(tl, top_k, e, capacity_factor)
    top_w, top_i = capacity_topk(w_te.transpose(1, 2), cap)      # (G, E, C)
    gi = torch.arange(g_cnt, device=x.device)[:, None, None]
    xc = xg[gi, top_i]                                           # (G,E,C,d)
    h = torch.einsum("gecd,edf->gecf", xc, p["wi"].to(x.dtype))
    y = torch.einsum("gecf,efd->gecd", _act(h, act), p["wo"].to(x.dtype))
    y = y * top_w[..., None].to(y.dtype)

    # the scatter in a fixed order: each (token, expert) slot written
    # once, then summed over the experts
    ei = torch.arange(e, device=x.device)[None, :, None]
    buf = torch.zeros((g_cnt, tl, e, d), dtype=y.dtype, device=x.device)
    buf[gi, top_i, ei] = y
    out = buf.sum(2)                                             # (G, t, d)

    frac_tokens = onehot.sum(2).mean(dim=(0, 1))                 # f_e
    frac_prob = probs.mean(dim=(0, 1))                           # P_e
    aux = {"lb_loss": e * (frac_tokens * frac_prob).sum(),
           "router_z": torch.logsumexp(logits, -1).square().mean()}
    out = out.reshape(b, t, d)
    if "shared" in p:
        out = out + dense_ffn(x, p["shared"], act)
    return out, aux
