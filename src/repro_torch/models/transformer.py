"""Model assembly — the port of repro/models/transformer.py for the
dense family's cache-free forward (the classifier targets) and the
token-serving path of the ssm (Mamba-2) and hybrid (RecurrentGemma)
families: parameter init, forward_logits, init_cache, prefill and
decode_step.

Layer parameters stay stacked on a leading L axis, as in the JAX
package; `_scan_uniform` and `_scan_with_cache` are Python loops over
that axis. Sharding constraints (`parallel/sharding.shard`) are the
identity on one card and are dropped. Activations run in `cfg.dtype`
over float32 master weights, cast at each use, as in JAX. On the card
the attention of a forward or a prefill runs on the `flash_attn`
kernel, the SSD scan on `ssd` and the RG-LRU recurrence on `rg_lru`;
decode steps are plain torch, as in JAX. The MoE FFN, int8 KV caches
and the dense, moe, encdec and vlm serving branches are not ported yet
(ROADMAP Queue 1): they raise NotImplementedError.

Entry points:
  init_params(gen, cfg, device)                  parameters
  forward_logits(params, cfg, batch)             teacher-forced logits
  init_cache(cfg, batch, max_len, device)        decode cache
  prefill(params, cfg, batch, max_len)           last logits + filled cache
  decode_step(params, cfg, cache, batch, pos)    one-token step
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention, common, ffn as ffn_mod, rglru, ssd

FULL_ATTN_MAX = 2048          # above this, the plain path goes chunked


def _cdtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _not_ported(what: str, cfg: ArchConfig):
    return NotImplementedError(
        f"{what} of family {cfg.family!r} is not ported yet (ROADMAP "
        "Queue 1); ported: the dense forward, ssm and hybrid serving")


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
    (dense, ssm and hybrid families); drawn on the generator's device,
    placed on `device` (default: the generator's)."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise _not_ported("init_params", cfg)
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": common.embed_init(gen, (v, d), device)}
    dev = params["embed"].device
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, (d, v), device=device)
    params["final_norm"] = common.init_norm(d, cfg.norm_type, dev)
    if cfg.family == "ssm":
        params["layers"] = {
            "ssd": ssd.init_ssd_block(gen, d, cfg.n_layers, cfg.ssm_state,
                                      cfg.ssm_expand, cfg.ssm_head_dim,
                                      cfg.conv_width, device),
            **_init_norms(cfg, cfg.n_layers, ("ln1",), device=dev),
        }
    elif cfg.family == "hybrid":
        kinds = cfg._layer_kinds()
        n_rec = kinds.count("rec")
        n_att = kinds.count("attn")
        params["rec_layers"] = {
            "mix": rglru.init_rglru_block(gen, d, cfg.lru_width, n_rec,
                                          cfg.conv_width, device),
            **_init_ffn(gen, cfg, n_rec, device),
            **_init_norms(cfg, n_rec, device=dev),
        }
        params["attn_layers"] = {
            "attn": _init_attn(gen, cfg, n_att, device),
            **_init_ffn(gen, cfg, n_att, device),
            **_init_norms(cfg, n_att, device=dev),
        }
    else:
        params["layers"] = {
            "attn": _init_attn(gen, cfg, cfg.n_layers, device),
            **_init_ffn(gen, cfg, cfg.n_layers, device),
            **_init_norms(cfg, cfg.n_layers, device=dev),
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
              prefix_len=0, cache=None, pos=None):
    """Attention mixer. cache = (k, v) buffers (bf16 or the config's
    dtype; int8 KV is not ported). With a cache (one decode token) it is
    `attention.attend_decode`, plain torch, on either device, as in JAX.

    Without one, a CUDA tensor goes through `attention.attend_flash`
    (the `flash_attn` kernel, windowed for "local") whatever the length;
    "prefix" raises there, not ported. On the CPU FULL_ATTN_MAX picks the
    plain branch, as in the JAX package."""
    q, k, v = _qkv(x, lp, cfg, positions)
    b, s = x.shape[:2]
    if cache is not None:
        if len(cache) != 2:
            raise NotImplementedError("int8 KV caches are not ported yet "
                                      "(ROADMAP Queue 1)")
        ck, cv = cache
        max_len = ck.shape[1]
        slot = pos % max_len if window else min(pos, max_len - 1)
        ck, cv = ck.clone(), cv.clone()       # the caller's cache stays
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        # a ring buffer: every slot is valid once pos >= window
        o = attention.attend_decode(
            q, ck, cv, min(pos + 1, max_len) if window else pos + 1)
        new_cache = (ck, cv)
    else:
        if q.is_cuda:
            o = attention.attend_flash(q, k, v, mask_kind=mask_kind,
                                       window=window)
        elif s <= FULL_ATTN_MAX:
            o = attention.attend_full(q, k, v, mask_kind=mask_kind,
                                      window=window, prefix_len=prefix_len)
        else:
            o = attention.attend_chunked(q, k, v, mask_kind=mask_kind,
                                         window=window,
                                         prefix_len=prefix_len)
        new_cache = (k, v)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return torch.einsum("bsh,hd->bsd", o, lp["wo"].to(x.dtype)), new_cache


def _ffn_apply(x, lp, cfg: ArchConfig):
    if cfg.family == "moe":
        raise NotImplementedError("the MoE FFN is not ported yet")
    return ffn_mod.dense_ffn(x, lp["ffn"], cfg.act), {}


def _decoder_layer(x, lp, cfg: ArchConfig, *, mask_kind, positions,
                   window=0, prefix_len=0, cache=None, pos=None):
    """One residual block: attention + ffn. Returns (x, cache, aux)."""
    h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
    att, new_cache = _attn_mix(h, lp["attn"], cfg, mask_kind=mask_kind,
                               positions=positions, window=window,
                               prefix_len=prefix_len, cache=cache, pos=pos)
    x = x + att
    h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
    f, aux = _ffn_apply(h, lp, cfg)
    return x + f, new_cache, aux


def _rec_layer(x, lp, cfg: ArchConfig, *, state=None, decode=False):
    h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
    mix, new_state = rglru.rglru_block(h, lp["mix"], state, decode)
    x = x + mix
    h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
    f, aux = _ffn_apply(h, lp, cfg)
    return x + f, new_state, aux


def _ssd_layer(x, lp, cfg: ArchConfig, *, state=None, decode=False):
    h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
    mix, new_state = ssd.ssd_block(h, lp["ssd"], cfg, state, decode)
    return x + mix, new_state, {}


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


def _scan_with_cache(x, stacked, cache, layer_fn):
    """Run a uniform stack with a per-layer cache: layer_fn(x, lp,
    cache_l) -> (x, new cache_l, aux). `cache` is a tuple of (L, ...)
    tensors (or None: each layer gets None); the new caches come back
    stacked the same way."""
    aux_acc: dict = {}
    outs = []
    for i in range(tree_leaves(stacked)[0].shape[0]):
        cache_l = None if cache is None else tuple(c[i] for c in cache)
        x, new_c, aux = layer_fn(x, layer_slice(stacked, i), cache_l)
        outs.append(new_c)
        for k, v in aux.items():
            aux_acc[k] = aux_acc.get(k, 0.0) + v
    return x, tuple(torch.stack(parts) for parts in zip(*outs)), aux_acc


# ===========================================================================
# embedding / head
# ===========================================================================

def _embed(params, cfg: ArchConfig, batch):
    """Token embedding, scaled by sqrt(d_model) in the compute dtype.
    (The vlm patch prefix is not ported.)"""
    if cfg.family == "vlm":
        raise _not_ported("the embedding", cfg)
    dt = _cdtype(cfg)
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device)
    x = emb[tokens].to(dt)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                            device=x.device)


def _head(x, params, cfg: ArchConfig):
    dt = x.dtype
    x = common.apply_norm(x, params["final_norm"], cfg.norm_type)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w.to(dt))


# ===========================================================================
# forward passes
# ===========================================================================

def _run_stack(params, cfg: ArchConfig, x, positions, *, mask_kind):
    """Training/eval forward through the body (no cache)."""
    if cfg.family == "ssm":
        def fn(x, lp):
            y, _, aux = _ssd_layer(x, lp, cfg)
            return y, aux
        return _scan_uniform(x, params["layers"], fn)
    if cfg.family == "hybrid":
        return _run_hybrid(params, cfg, x, positions)
    if cfg.family != "dense":
        raise _not_ported("forward_logits", cfg)

    def fn(x, lp):
        y, _, aux = _decoder_layer(x, lp, cfg, mask_kind=mask_kind,
                                   positions=positions,
                                   window=cfg.window_size)
        return y, aux
    return _scan_uniform(x, params["layers"], fn)


def _run_hybrid(params, cfg: ArchConfig, x, positions):
    """The hybrid stack in layer order: the JAX package scans over whole
    repeats of the block pattern, then unrolls the remainder; in eager
    torch both are the same loop over the layer kinds."""
    rec, att = params["rec_layers"], params["attn_layers"]
    ri = ai = 0
    for kind in cfg._layer_kinds():
        if kind == "rec":
            x, _, _ = _rec_layer(x, layer_slice(rec, ri), cfg)
            ri += 1
        else:
            x, _, _ = _decoder_layer(x, layer_slice(att, ai), cfg,
                                     mask_kind="local", positions=positions,
                                     window=cfg.window_size)
            ai += 1
    return x, {}


def forward_logits(params, cfg: ArchConfig, batch):
    """Teacher-forced logits over the full sequence: (logits, aux)."""
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params, cfg, x, positions, mask_kind="causal")
    return _head(x, params, cfg), aux


# ===========================================================================
# serving: cache init / prefill / decode
# ===========================================================================

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    dt = _cdtype(cfg)
    k, dh = cfg.n_kv_heads, cfg.d_head
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        d_xbc = d_in + 2 * cfg.ssm_state
        return {"conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                                     d_xbc), dtype=dt, device=device),
                "ssm": torch.zeros((cfg.n_layers, batch, nh, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)}
    if cfg.family == "hybrid":
        kinds = cfg._layer_kinds()
        n_rec, n_att = kinds.count("rec"), kinds.count("attn")
        w = min(cfg.window_size, max_len)
        return {"conv": torch.zeros((n_rec, batch, cfg.conv_width - 1,
                                     cfg.lru_width), dtype=dt, device=device),
                "h": torch.zeros((n_rec, batch, cfg.lru_width),
                                 dtype=torch.float32, device=device),
                "k": torch.zeros((n_att, batch, w, k, dh), dtype=dt,
                                 device=device),
                "v": torch.zeros((n_att, batch, w, k, dh), dtype=dt,
                                 device=device)}
    raise _not_ported("init_cache", cfg)


def decode_step(params, cfg: ArchConfig, cache, batch, pos: int):
    """One new token against a filled cache. batch: {"tokens": (B, 1)};
    pos is the token's absolute position. Returns (logits (B, V), cache)."""
    x = _embed(params, cfg, batch)
    positions = torch.full((1,), pos, device=x.device)
    if cfg.family == "ssm":
        def fn(x, lp, cache_l):
            return _ssd_layer(x, lp, cfg, state=cache_l, decode=True)
        x, new_cache, _ = _scan_with_cache(
            x, params["layers"], (cache["conv"], cache["ssm"]), fn)
        cache = {"conv": new_cache[0], "ssm": new_cache[1]}
    elif cfg.family == "hybrid":
        x, cache = _decode_hybrid(params, cfg, cache, x, positions, pos)
    else:
        raise _not_ported("decode_step", cfg)
    return _head(x, params, cfg)[:, -1], cache


def _decode_hybrid(params, cfg: ArchConfig, cache, x, positions, pos):
    rec, att = params["rec_layers"], params["attn_layers"]
    new_conv, new_h, new_k, new_v = [], [], [], []
    ri = ai = 0
    for kind in cfg._layer_kinds():
        if kind == "rec":
            st = (cache["conv"][ri], cache["h"][ri])
            x, (c2, h2), _ = _rec_layer(x, layer_slice(rec, ri), cfg,
                                        state=st, decode=True)
            new_conv.append(c2)
            new_h.append(h2)
            ri += 1
        else:
            x, (k2, v2), _ = _decoder_layer(
                x, layer_slice(att, ai), cfg, mask_kind="causal",
                positions=positions, window=cfg.window_size,
                cache=(cache["k"][ai], cache["v"][ai]), pos=pos)
            new_k.append(k2)
            new_v.append(v2)
            ai += 1
    cache = {"conv": torch.stack(new_conv), "h": torch.stack(new_h),
             "k": torch.stack(new_k), "v": torch.stack(new_v)}
    return x, cache


def prefill(params, cfg: ArchConfig, batch, max_len: int | None = None):
    """Process the full prompt; return (last-token logits, cache)."""
    x = _embed(params, cfg, batch)
    max_len = max_len or x.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        def fn(x, lp, _c):
            return _ssd_layer(x, lp, cfg, state=None)
        x, states, _ = _scan_with_cache(x, params["layers"], None, fn)
        cache = {"conv": states[0], "ssm": states[1]}
    elif cfg.family == "hybrid":
        x, cache = _prefill_hybrid(params, cfg, x, positions, max_len)
    else:
        raise _not_ported("prefill", cfg)
    # head on the last position only: full (B, S, V) logits would be the
    # dominant memory traffic of prefill
    return _head(x[:, -1:], params, cfg)[:, -1], cache


def _ring_cache(t, w: int):
    """The window cache of a prefill: (B, S, K, Dh) keys or values -> (B,
    w, K, Dh) in ring order, the token at position p in slot p % w (the
    slot decode writes it to), the last min(S, w) tokens kept and empty
    slots zero. The JAX package's _prefill_hybrid keeps k[:, -w:] rolled,
    which is this when S >= w; for a prompt shorter than the window it
    keeps only S slots, and decode then overwrites the first prompt token
    and forgets all but S (ROADMAP Queue 3)."""
    s = t.shape[1]
    p0 = max(s - w, 0)
    out = torch.zeros((t.shape[0], w) + tuple(t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    out[:, torch.arange(p0, s, device=t.device) % w] = t[:, p0:]
    return out


def _prefill_hybrid(params, cfg: ArchConfig, x, positions, max_len):
    rec, att = params["rec_layers"], params["attn_layers"]
    w = min(cfg.window_size, max_len)
    convs, hs, ks, vs = [], [], [], []
    ri = ai = 0
    for kind in cfg._layer_kinds():
        if kind == "rec":
            x, (c2, h2), _ = _rec_layer(x, layer_slice(rec, ri), cfg)
            convs.append(c2)
            hs.append(h2)
            ri += 1
        else:
            x, (k2, v2), _ = _decoder_layer(x, layer_slice(att, ai), cfg,
                                            mask_kind="local",
                                            positions=positions,
                                            window=cfg.window_size)
            ks.append(_ring_cache(k2, w))
            vs.append(_ring_cache(v2, w))
            ai += 1
    return x, {"conv": torch.stack(convs), "h": torch.stack(hs),
               "k": torch.stack(ks), "v": torch.stack(vs)}
