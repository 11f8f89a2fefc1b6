"""Model assembly — the port of repro/models/transformer.py's forward and
serving path for the whole model zoo: decoder-only LM (dense), MoE,
hybrid (RecurrentGemma), SSM (Mamba-2), enc-dec (Whisper) and VLM
(PaliGemma): parameter init, forward_logits, train_loss, init_cache,
prefill and decode_step.

Layer parameters stay stacked on a leading L axis, as in the JAX
package; `_scan_uniform` and `_scan_with_cache` are Python loops over
that axis. Sharding constraints (`parallel/sharding.shard`) are the
identity on one card and are dropped. Activations run in `cfg.dtype`
over float32 master weights, cast at each use, as in JAX. On the card
every attention without a cache (a forward, a prefill, an encoder,
cross-attention to the encoder) runs on the `flash_attn` kernel, the
SSD scan on `ssd` and the RG-LRU recurrence on `rg_lru`; decode steps
are plain torch, as in JAX. The MoE FFN's expert products are plain
einsums (`models/ffn.py`), as in JAX. Under grad (`train_loss`) the same
kernels run through their autograd Functions, whose backwards are kernels
too (flash_attn's at every head dim and mask, ssd's, rg_lru's). `remat`
wraps each layer (each hybrid block pattern) in a non-reentrant
`torch.utils.checkpoint`, as JAX's `jax.checkpoint`: the layer's
activations are recomputed in the backward instead of kept.

Departures from the JAX package, each tested (ROADMAP Queue 3): a
hybrid prefill shorter than the window keeps a full ring of w slots
(`_ring_cache`); a prefill whose filled length (the VLM's image prefix
plus the prompt) exceeds `max_len` raises instead of cutting the cache,
and `max_len` defaults to that filled length.

Entry points:
  init_params(gen, cfg, device)                  parameters
  forward_logits(params, cfg, batch, remat)      teacher-forced logits
  train_loss(params, cfg, batch, remat)          LM loss (+ MoE aux), aux
  init_cache(cfg, batch, max_len, device)        decode cache
  prefill(params, cfg, batch, max_len)           last logits + filled cache
  decode_step(params, cfg, cache, batch, pos)    one-token step

batch: {"tokens": (B, S)}, with "patches" (B, P, d) for the vlm family
(stub image embeddings) and "frames" (B, S_enc, d) for encdec (stub audio
frame embeddings).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention, common, ffn as ffn_mod, rglru, ssd

FULL_ATTN_MAX = 2048          # above this, the plain path goes chunked


def _cdtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
        return {"moe": ffn_mod.init_moe(gen, cfg.d_model, cfg.d_expert,
                                        cfg.n_experts, cfg.act, n,
                                        cfg.n_shared_experts, device)}
    return {"ffn": ffn_mod.init_dense_ffn(gen, cfg.d_model, cfg.d_ff,
                                          cfg.act, n, device)}


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Random parameters with the JAX package's keys, shapes and scales;
    drawn on the generator's device, placed on `device` (default: the
    generator's)."""
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
    elif cfg.family == "encdec":
        params["enc_layers"] = {
            "attn": _init_attn(gen, cfg, cfg.n_enc_layers, device),
            **_init_ffn(gen, cfg, cfg.n_enc_layers, device),
            **_init_norms(cfg, cfg.n_enc_layers, device=dev),
        }
        params["layers"] = {
            "attn": _init_attn(gen, cfg, cfg.n_layers, device),
            "xattn": _init_attn(gen, cfg, cfg.n_layers, device),
            **_init_ffn(gen, cfg, cfg.n_layers, device),
            **_init_norms(cfg, cfg.n_layers, ("ln1", "ln2", "ln3"),
                          device=dev),
        }
        params["enc_norm"] = common.init_norm(d, cfg.norm_type, dev)
        params["frontend"] = common.dense_init(gen, (d, d), device=device)
    else:                                   # dense / moe / vlm
        params["layers"] = {
            "attn": _init_attn(gen, cfg, cfg.n_layers, device),
            **_init_ffn(gen, cfg, cfg.n_layers, device),
            **_init_norms(cfg, cfg.n_layers, device=dev),
        }
        if cfg.family == "vlm":
            params["frontend"] = common.dense_init(gen, (d, d),
                                                   device=device)
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


def _quant_kv(t):
    """Per-(batch, head) symmetric int8 quant of K or V along its last
    (head) axis: (codes, float32 scales)."""
    t = t.float()
    scale = (t.abs().amax(-1) / 127.0).clamp(min=1e-8)
    q = torch.round(t / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _attn_mix(x, lp, cfg: ArchConfig, *, mask_kind, positions, window=0,
              prefix_len=0, cache=None, pos=None):
    """Attention mixer. cache = (k, v[, k_scale, v_scale]) buffers: the
    config's dtype, or int8 codes with float32 scales. With a cache (one
    decode token) it is `attention.attend_decode`, plain torch, on
    either device, as in JAX; an int8 cache is dequantized in bfloat16,
    as in JAX.

    Without one, a CUDA tensor goes through `attention.attend_flash`
    (the `flash_attn` kernel) whatever the length and mask; on the CPU
    FULL_ATTN_MAX picks the plain branch, as in the JAX package."""
    q, k, v = _qkv(x, lp, cfg, positions)
    b, s = x.shape[:2]
    if cache is not None:
        ck, cv = cache[0].clone(), cache[1].clone()  # the caller's stays
        max_len = ck.shape[1]
        slot = pos % max_len if window else min(pos, max_len - 1)
        if len(cache) == 4:
            cks, cvs = cache[2].clone(), cache[3].clone()
            ck[:, slot], cks[:, slot] = _quant_kv(k[:, 0])
            cv[:, slot], cvs[:, slot] = _quant_kv(v[:, 0])
            bf = torch.bfloat16
            dk = ck.to(bf) * cks[..., None].to(bf)
            dv = cv.to(bf) * cvs[..., None].to(bf)
            new_cache = (ck, cv, cks, cvs)
        else:
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            dk, dv = ck, cv
            new_cache = (ck, cv)
        # a ring buffer: every slot is valid once pos >= window
        o = attention.attend_decode(
            q, dk, dv, min(pos + 1, max_len) if window else pos + 1)
    else:
        o = _attend(q, k, v, mask_kind=mask_kind, window=window,
                    prefix_len=prefix_len)
        new_cache = (k, v)
    # an int8 cache dequantizes in bfloat16: o is promoted to x's dtype
    # for the projection, as JAX's einsum promotes
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head).to(x.dtype)
    return torch.einsum("bsh,hd->bsd", o, lp["wo"].to(x.dtype)), new_cache


def _attend(q, k, v, *, mask_kind, window=0, prefix_len=0):
    """Attention without a cache: the kernel on the card, else the JAX
    package's choice of the plain full or chunked form by key length."""
    if q.is_cuda:
        return attention.attend_flash(q, k, v, mask_kind=mask_kind,
                                      window=window, prefix_len=prefix_len)
    fn = attention.attend_full if k.shape[1] <= FULL_ATTN_MAX \
        else attention.attend_chunked
    return fn(q, k, v, mask_kind=mask_kind, window=window,
              prefix_len=prefix_len)


def _ffn_apply(x, lp, cfg: ArchConfig):
    if cfg.family == "moe":
        return ffn_mod.moe_ffn(x, lp["moe"], cfg.act, cfg.moe_top_k,
                               cfg.capacity_factor, cfg.moe_groups)
    return ffn_mod.dense_ffn(x, lp["ffn"], cfg.act), {}


def _decoder_layer(x, lp, cfg: ArchConfig, *, mask_kind, positions,
                   window=0, prefix_len=0, cache=None, pos=None, xa=None):
    """One residual block: attention [+ cross-attention to the encoder
    states `xa`] + ffn. Returns (x, cache, aux)."""
    h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
    att, new_cache = _attn_mix(h, lp["attn"], cfg, mask_kind=mask_kind,
                               positions=positions, window=window,
                               prefix_len=prefix_len, cache=cache, pos=pos)
    x = x + att
    if xa is not None:                     # enc-dec cross attention
        h = common.apply_norm(x, lp["ln3"], cfg.norm_type)
        x = x + _cross_attn(h, lp["xattn"], cfg, xa)
    h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
    f, aux = _ffn_apply(h, lp, cfg)
    return x + f, new_cache, aux


def _cross_kv(enc_out, lp, cfg: ArchConfig, dtype):
    """Cross-attention keys and values of the encoder states: (B, S_enc,
    K, Dh) each, no RoPE."""
    b, se = enc_out.shape[:2]
    kk = torch.einsum("bsd,dh->bsh", enc_out, lp["wk"].to(dtype))
    v = torch.einsum("bsd,dh->bsh", enc_out, lp["wv"].to(dtype))
    return (kk.reshape(b, se, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, se, cfg.n_kv_heads, cfg.d_head))


def _cross_attn(x, lp, cfg: ArchConfig, enc_out):
    """Cross-attention to (precomputed) encoder states; no RoPE on keys.
    On the card bidir `flash_attn` with Skv the encoder length; on the
    CPU the JAX package's choice (full, chunked, or decode-form for one
    query over a long encoder)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = torch.einsum("bsd,dh->bsh", x, lp["wq"].to(x.dtype)) \
        .reshape(b, s, h, dh)
    kk, v = _cross_kv(enc_out, lp, cfg, x.dtype)
    if q.is_cuda or enc_out.shape[1] <= FULL_ATTN_MAX or s > 1:
        o = _attend(q, kk, v, mask_kind="bidir")
    else:
        o = attention.attend_decode(q, kk, v, kk.shape[1])
    o = o.reshape(b, s, h * dh)
    return torch.einsum("bsh,hd->bsd", o, lp["wo"].to(x.dtype))


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


def unstacked(stacked) -> list:
    """Every layer of a tree of stacked (L, ...) parameters, by one
    `torch.unbind` a leaf: under grad its backward stacks the layers'
    gradients in one op, where indexing each layer out would add L
    full-size (L, ...) gradients."""
    if isinstance(stacked, dict):
        parts = {k: unstacked(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _rematted(fn, remat: bool):
    """fn itself, or fn under a non-reentrant activation checkpoint: its
    forward keeps only its inputs, and the backward runs it again."""
    if not remat:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _scan_uniform(x, stacked, layer_fn, remat: bool = False):
    """Run a uniform stack in order; layer_fn(x, lp) -> (x, aux dict),
    aux summed over the layers; `remat` checkpoints each layer."""
    aux_acc: dict = {}
    fn = _rematted(layer_fn, remat)
    for lp in unstacked(stacked):
        x, aux = fn(x, lp)
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

def _embed(params, cfg: ArchConfig, batch, *, decode=False):
    """Token (+ stub image) embedding: (x, prefix_len). Tokens are scaled
    by sqrt(d_model) in the compute dtype; outside decode the vlm family
    prepends its patches through the frontend projection."""
    dt = _cdtype(cfg)
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device)
    x = emb[tokens].to(dt)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=x.device)
    prefix_len = 0
    if cfg.family == "vlm" and not decode:
        patches = torch.as_tensor(batch["patches"], device=emb.device) \
            .to(dt)                                       # (B, P, d) stub
        patches = torch.einsum("bpd,de->bpe", patches,
                               params["frontend"].to(dt))
        x = torch.cat([patches, x], dim=1)
        prefix_len = patches.shape[1]
    return x, prefix_len


def _head(x, params, cfg: ArchConfig):
    dt = x.dtype
    x = common.apply_norm(x, params["final_norm"], cfg.norm_type)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w.to(dt))


# ===========================================================================
# forward passes
# ===========================================================================

def _run_stack(params, cfg: ArchConfig, x, positions, *, mask_kind,
               prefix_len=0, remat=False):
    """Training/eval forward through the body (no cache)."""
    if cfg.family == "ssm":
        def fn(x, lp):
            y, _, aux = _ssd_layer(x, lp, cfg)
            return y, aux
        return _scan_uniform(x, params["layers"], fn, remat)
    if cfg.family == "hybrid":
        return _run_hybrid(params, cfg, x, positions, remat=remat)
    if cfg.family == "encdec":
        raise ValueError("use forward_encoder")

    def fn(x, lp):
        y, _, aux = _decoder_layer(x, lp, cfg, mask_kind=mask_kind,
                                   positions=positions,
                                   window=cfg.window_size,
                                   prefix_len=prefix_len)
        return y, aux
    return _scan_uniform(x, params["layers"], fn, remat)


def _run_hybrid(params, cfg: ArchConfig, x, positions, *, remat=False):
    """The hybrid stack in layer order: the JAX package scans over whole
    repeats of the block pattern (each repeat one checkpoint under
    `remat`), then unrolls the remainder (never checkpointed); in eager
    torch both are the same loop over the layer kinds."""
    rec = unstacked(params["rec_layers"])
    att = unstacked(params["attn_layers"])
    pat = list(cfg.block_pattern)
    n_full = cfg.n_layers // len(pat)

    def run(x, kinds, ri, ai):
        for kind in kinds:
            if kind == "rec":
                x, _, _ = _rec_layer(x, rec[ri], cfg)
                ri += 1
            else:
                x, _, _ = _decoder_layer(x, att[ai], cfg,
                                         mask_kind="local",
                                         positions=positions,
                                         window=cfg.window_size)
                ai += 1
        return x

    n_rec, n_att = pat.count("rec"), pat.count("attn")
    block = _rematted(lambda x, i: run(x, pat, i * n_rec, i * n_att), remat)
    for i in range(n_full):
        x = block(x, i)
    x = run(x, cfg._layer_kinds()[n_full * len(pat):], n_full * n_rec,
            n_full * n_att)
    return x, {}


def forward_encoder(params, cfg: ArchConfig, batch):
    """The enc-dec encoder over the stub frames: frontend projection,
    bidir layers, final norm."""
    dt = _cdtype(cfg)
    frontend = params["frontend"]
    frames = torch.as_tensor(batch["frames"], device=frontend.device) \
        .to(dt)                                           # (B, S, d) stub
    x = torch.einsum("bsd,de->bse", frames, frontend.to(dt))
    positions = torch.arange(x.shape[1], device=x.device)

    def fn(x, lp):
        y, _, aux = _decoder_layer(x, lp, cfg, mask_kind="bidir",
                                   positions=positions)
        return y, aux
    x, _ = _scan_uniform(x, params["enc_layers"], fn)
    return common.apply_norm(x, params["enc_norm"], cfg.norm_type)


def forward_logits(params, cfg: ArchConfig, batch, *, remat=False):
    """Teacher-forced logits over the full sequence (the vlm family's
    image prefix included): (logits, aux), aux the MoE load-balance stats
    summed over the layers ({} for other families). `remat` checkpoints
    each decoder layer (each hybrid block pattern), not the encoder's."""
    if cfg.family == "encdec":
        enc = forward_encoder(params, cfg, batch)
        x, _ = _embed(params, cfg, batch)
        positions = torch.arange(x.shape[1], device=x.device)

        def fn(x, lp):
            y, _, aux = _decoder_layer(x, lp, cfg, mask_kind="causal",
                                       positions=positions, xa=enc)
            return y, aux
        x, aux = _scan_uniform(x, params["layers"], fn, remat)
        return _head(x, params, cfg), aux
    x, prefix_len = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    mask_kind = "prefix" if cfg.family == "vlm" else "causal"
    x, aux = _run_stack(params, cfg, x, positions, mask_kind=mask_kind,
                        prefix_len=prefix_len, remat=remat)
    return _head(x, params, cfg), aux


def train_loss(params, cfg: ArchConfig, batch, *, remat=True):
    """Mean next-token cross-entropy over batch["labels"] (ignore id -1;
    the vlm family's image prefix carries no loss), plus 0.01 lb_loss +
    1e-4 router_z for the moe family: (loss, aux)."""
    logits, aux = forward_logits(params, cfg, batch, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if cfg.family == "vlm":                  # image prefix carries no loss
        pad = torch.full(labels.shape[:1]
                         + (logits.shape[1] - labels.shape[1],), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = common.cross_entropy(logits, labels)
    if aux:
        loss = loss + 0.01 * aux.get("lb_loss", 0.0) \
            + 1e-4 * aux.get("router_z", 0.0)
    return loss, aux


# ===========================================================================
# serving: cache init / prefill / decode
# ===========================================================================

def _int8_kv(cfg: ArchConfig) -> bool:
    """int8 KV caches are the dense and vlm families', as in JAX."""
    return cfg.kv_cache_dtype == "int8" and cfg.family in ("dense", "vlm")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    dt = _cdtype(cfg)
    k, dh = cfg.n_kv_heads, cfg.d_head

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        d_xbc = d_in + 2 * cfg.ssm_state
        return {"conv": zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                               d_xbc), dt),
                "ssm": zeros((cfg.n_layers, batch, nh, cfg.ssm_head_dim,
                              cfg.ssm_state), torch.float32)}
    if cfg.family == "hybrid":
        kinds = cfg._layer_kinds()
        n_rec, n_att = kinds.count("rec"), kinds.count("attn")
        w = min(cfg.window_size, max_len)
        return {"conv": zeros((n_rec, batch, cfg.conv_width - 1,
                               cfg.lru_width), dt),
                "h": zeros((n_rec, batch, cfg.lru_width), torch.float32),
                "k": zeros((n_att, batch, w, k, dh), dt),
                "v": zeros((n_att, batch, w, k, dh), dt)}
    kv_dt = torch.int8 if _int8_kv(cfg) else dt
    shape = (cfg.n_layers, batch, max_len, k, dh)
    cache = {"k": zeros(shape, kv_dt), "v": zeros(shape, kv_dt)}
    if kv_dt == torch.int8:
        cache["ks"] = zeros(shape[:-1], torch.float32)
        cache["vs"] = zeros(shape[:-1], torch.float32)
    if cfg.family == "encdec":
        cache["xk"] = zeros(shape, dt)
        cache["xv"] = zeros(shape, dt)
    return cache


def decode_step(params, cfg: ArchConfig, cache, batch, pos: int):
    """One new token against a filled cache. batch: {"tokens": (B, 1)};
    pos is the token's absolute position (the vlm family's counts its
    image prefix). Returns (logits (B, V), cache)."""
    x, _ = _embed(params, cfg, batch, decode=True)
    positions = torch.full((1,), pos, device=x.device)
    if cfg.family == "ssm":
        def fn(x, lp, cache_l):
            return _ssd_layer(x, lp, cfg, state=cache_l, decode=True)
        x, new_cache, _ = _scan_with_cache(
            x, params["layers"], (cache["conv"], cache["ssm"]), fn)
        cache = {"conv": new_cache[0], "ssm": new_cache[1]}
    elif cfg.family == "hybrid":
        x, cache = _decode_hybrid(params, cfg, cache, x, positions, pos)
    elif cfg.family == "encdec":
        def fn(x, lp, cache_l):
            ck, cv, xk, xv = cache_l
            h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
            att, (nk, nv) = _attn_mix(h, lp["attn"], cfg, mask_kind="causal",
                                      positions=positions, cache=(ck, cv),
                                      pos=pos)
            x = x + att
            h = common.apply_norm(x, lp["ln3"], cfg.norm_type)
            b = x.shape[0]
            q = torch.einsum("bsd,dh->bsh", h,
                             lp["xattn"]["wq"].to(h.dtype)) \
                .reshape(b, 1, cfg.n_heads, cfg.d_head)
            o = attention.attend_decode(q, xk, xv, xk.shape[1]) \
                .reshape(b, 1, cfg.n_heads * cfg.d_head)
            x = x + torch.einsum("bsh,hd->bsd", o,
                                 lp["xattn"]["wo"].to(h.dtype))
            h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
            f, aux = _ffn_apply(h, lp, cfg)
            return x + f, (nk, nv, xk, xv), aux
        x, new_cache, _ = _scan_with_cache(
            x, params["layers"],
            (cache["k"], cache["v"], cache["xk"], cache["xv"]), fn)
        cache = dict(zip(("k", "v", "xk", "xv"), new_cache))
    else:
        names = ("k", "v", "ks", "vs") if "ks" in cache else ("k", "v")

        def fn(x, lp, cache_l):
            return _decoder_layer(x, lp, cfg, mask_kind="causal",
                                  positions=positions, cache=cache_l,
                                  pos=pos)
        x, new_cache, _ = _scan_with_cache(
            x, params["layers"], tuple(cache[n] for n in names), fn)
        cache = dict(zip(names, new_cache))
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
    """Process the full prompt (the vlm family's image prefix and the
    encdec family's encoder included); return (last-token logits,
    cache). The cache holds max_len slots (default: the filled length,
    prefix plus prompt); a filled length past max_len raises."""
    x, prefix_len = _embed(params, cfg, batch)
    filled = x.shape[1]
    max_len = max_len or filled
    positions = torch.arange(filled, device=x.device)
    if cfg.family == "ssm":
        def fn(x, lp, _c):
            return _ssd_layer(x, lp, cfg, state=None)
        x, states, _ = _scan_with_cache(x, params["layers"], None, fn)
        cache = {"conv": states[0], "ssm": states[1]}
    elif cfg.family == "hybrid":
        x, cache = _prefill_hybrid(params, cfg, x, positions, max_len)
    elif cfg.family == "encdec":
        x, cache = _prefill_encdec(params, cfg, batch, x, positions,
                                   max_len)
    else:
        mask_kind = "prefix" if cfg.family == "vlm" else "causal"

        def fn(x, lp, _c):
            return _decoder_layer(x, lp, cfg, mask_kind=mask_kind,
                                  positions=positions,
                                  window=cfg.window_size,
                                  prefix_len=prefix_len)
        x, (k2, v2), _ = _scan_with_cache(x, params["layers"], None, fn)
        if _int8_kv(cfg):
            (kq, ks), (vq, vs) = _quant_kv(k2), _quant_kv(v2)
            cache = {"k": _pad_cache(kq, max_len),
                     "v": _pad_cache(vq, max_len),
                     "ks": _pad_cache(ks, max_len),
                     "vs": _pad_cache(vs, max_len)}
        else:
            cache = {"k": _pad_cache(k2, max_len),
                     "v": _pad_cache(v2, max_len)}
    # head on the last position only: full (B, S, V) logits would be the
    # dominant memory traffic of prefill
    return _head(x[:, -1:], params, cfg)[:, -1], cache


def _prefill_encdec(params, cfg: ArchConfig, batch, x, positions, max_len):
    """The encoder once, then the decoder over the prompt: self-attention
    caches padded to max_len, the cross keys and values at the encoder's
    length."""
    enc = forward_encoder(params, cfg, batch)

    def fn(x, lp, _c):
        h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
        att, (k2, v2) = _attn_mix(h, lp["attn"], cfg, mask_kind="causal",
                                  positions=positions)
        x = x + att
        h = common.apply_norm(x, lp["ln3"], cfg.norm_type)
        x = x + _cross_attn(h, lp["xattn"], cfg, enc)
        h = common.apply_norm(x, lp["ln2"], cfg.norm_type)
        f, aux = _ffn_apply(h, lp, cfg)
        xk, xv = _cross_kv(enc, lp["xattn"], cfg, x.dtype)
        return x + f, (k2, v2, xk, xv), aux
    x, (k2, v2, xk, xv), _ = _scan_with_cache(x, params["layers"], None, fn)
    return x, {"k": _pad_cache(k2, max_len), "v": _pad_cache(v2, max_len),
               "xk": xk, "xv": xv}


def _pad_cache(c, max_len: int):
    """(L, B, S, ...) -> (L, B, max_len, ...), zeros after the S filled
    slots. The JAX package's _pad_cache cuts the cache to max_len when S
    is longer (its vlm prefill's default max_len, the token count, drops
    the last P filled slots); here that raises (ROADMAP Queue 3)."""
    s = c.shape[2]
    if s > max_len:
        raise ValueError(f"prefill: the filled length {s} (image prefix "
                         f"plus prompt) exceeds max_len {max_len}")
    out = torch.zeros(c.shape[:2] + (max_len,) + tuple(c.shape[3:]),
                      dtype=c.dtype, device=c.device)
    out[:, :, :s] = c
    return out


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
