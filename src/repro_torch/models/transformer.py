"""Model assembly, the dense subset — the port of the parts of
repro/models/transformer.py that a bidirectional classifier encoder
runs: parameter init (dense branch), the QKV projection with RoPE,
the attention mixer without a cache, the dense FFN and the residual
block. Layer parameters stay stacked on a leading L axis, as in the JAX
package; `_scan_uniform` is a Python loop over that axis. Sharding
constraints (`parallel/sharding.shard`) are the identity on one card and
are dropped. MoE, the other families, decode caches and the LM head are
not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention, common, ffn as ffn_mod

FULL_ATTN_MAX = 2048          # above this, the plain path goes chunked


# ===========================================================================
# parameter init
# ===========================================================================

def _init_attn(gen, cfg: ArchConfig, n: int, device=None):
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": common.dense_init(gen, (n, d, h * dh), device=device),
        "wk": common.dense_init(gen, (n, d, k * dh), device=device),
        "wv": common.dense_init(gen, (n, d, k * dh), device=device),
        "wo": common.dense_init(gen, (n, h * dh, d), in_axis=-2,
                                device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * dh), device=device)
        p["bk"] = torch.zeros((n, k * dh), device=device)
        p["bv"] = torch.zeros((n, k * dh), device=device)
    return p


def _init_norms(cfg: ArchConfig, n: int, names=("ln1", "ln2"), device=None):
    out = {}
    for nm in names:
        base = common.init_norm(cfg.d_model, cfg.norm_type, device)
        out[nm] = {k: a.expand((n,) + tuple(a.shape)).clone()
                   for k, a in base.items()}
    return out


def _init_ffn(gen, cfg: ArchConfig, n: int, device=None):
    if cfg.family == "moe":
        raise NotImplementedError("the MoE FFN is not ported yet")
    return {"ffn": ffn_mod.init_dense_ffn(gen, cfg.d_model, cfg.d_ff,
                                          cfg.act, n, device)}


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Random parameters with the JAX package's keys, shapes and scales
    (dense family); drawn on the generator's device, placed on `device`
    (default: the generator's)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense is)")
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": common.embed_init(gen, (v, d), device)}
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, (d, v), device=device)
    params["final_norm"] = common.init_norm(d, cfg.norm_type,
                                            params["embed"].device)
    params["layers"] = {
        "attn": _init_attn(gen, cfg, cfg.n_layers, device),
        **_init_ffn(gen, cfg, cfg.n_layers, device),
        **_init_norms(cfg, cfg.n_layers, device=params["embed"].device),
    }
    return params


# ===========================================================================
# blocks
# ===========================================================================

def _qkv(x, lp, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.einsum("bsd,dh->bsh", x, lp["wq"].to(x.dtype))
    kk = torch.einsum("bsd,dh->bsh", x, lp["wk"].to(x.dtype))
    v = torch.einsum("bsd,dh->bsh", x, lp["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + lp["bq"].to(x.dtype)
        kk = kk + lp["bk"].to(x.dtype)
        v = v + lp["bv"].to(x.dtype)
    q = q.reshape(b, s, h, dh)
    kk = kk.reshape(b, s, k, dh)
    v = v.reshape(b, s, k, dh)
    q = common.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    kk = common.apply_rope(kk, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, kk, v


def _attn_mix(x, lp, cfg: ArchConfig, *, mask_kind, positions, window=0,
              prefix_len=0):
    """Attention mixer (no cache). On the card every mask the kernel
    takes goes through `attention.attend_flash`, whatever the length
    (both plain branches compute the same exact attention); on the CPU
    FULL_ATTN_MAX picks the plain branch, as in the JAX package."""
    q, k, v = _qkv(x, lp, cfg, positions)
    b, s = x.shape[:2]
    if q.is_cuda:
        o = attention.attend_flash(q, k, v, mask_kind=mask_kind)
    elif s <= FULL_ATTN_MAX:
        o = attention.attend_full(q, k, v, mask_kind=mask_kind,
                                  window=window, prefix_len=prefix_len)
    else:
        o = attention.attend_chunked(q, k, v, mask_kind=mask_kind,
                                     window=window, prefix_len=prefix_len)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return torch.einsum("bsh,hd->bsd", o, lp["wo"].to(x.dtype)), (k, v)


def _ffn_apply(x, lp, cfg: ArchConfig):
    if cfg.family == "moe":
        raise NotImplementedError("the MoE FFN is not ported yet")
    return ffn_mod.dense_ffn(x, lp["ffn"], cfg.act), {}


def _decoder_layer(x, lp, cfg: ArchConfig, *, mask_kind, positions,
                   window=0, prefix_len=0):
    """One residual block: attention + ffn. Returns (x, (k, v), aux)."""
    h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
    att, kv = _attn_mix(h, lp["attn"], cfg, mask_kind=mask_kind,
                        positions=positions, window=window,
                        prefix_len=prefix_len)
    x = x + att
    h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
    f, aux = _ffn_apply(h, lp, cfg)
    return x + f, kv, aux


# ===========================================================================
# stacks
# ===========================================================================

def layer_slice(stacked, i):
    """Layer i of a tree of stacked (L, ...) parameters."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _scan_uniform(x, stacked, layer_fn):
    """Run a uniform stack in order; layer_fn(x, lp) -> (x, aux dict),
    aux summed over the layers."""
    aux_acc: dict = {}
    for i in range(tree_leaves(stacked)[0].shape[0]):
        x, aux = layer_fn(x, layer_slice(stacked, i))
        for k, v in aux.items():
            aux_acc[k] = aux_acc.get(k, 0.0) + v
    return x, aux_acc
