"""GQA attention: full / chunked online-softmax / decode-with-cache
(plain torch), and the flash_attn kernel front — the port of
repro/models/attention.py.

`attend_full`, `attend_chunked` and `attend_decode` are the plain
versions, op for op the JAX functions. `attend_flash` is what a CUDA
tensor takes in a forward or a prefill (`transformer._attn_mix`,
`_cross_attn`): the exact attention of `attend_full` for the bidir,
causal, local and prefix masks, computed by the hand-written
`flash_attn` kernel without the S x S scores. The JAX package's comment that its Pallas kernels "take
over" on the TPU was never wired; here the card goes through the
kernel. One-token decode against a cache is `attend_decode` in plain
torch on either device, as in JAX.

Layout convention: q (B, S, H, Dh), k/v (B, S, K, Dh) with H = K * G.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common


def _split_groups(q, n_kv: int):
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def attend_full(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                prefix_len: int = 0, q_offset=0, scale: float | None = None):
    """Reference attention; used for small seqs, tests, and smoke configs."""
    b, sq, h, dh = q.shape
    n_kv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = _split_groups(q, n_kv)                                  # b s k g d
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    pred = common.mask_fn(mask_kind, window, prefix_len)
    m = pred(qpos[:, None], kpos[None, :])                       # (sq, skv)
    s = torch.where(m[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dh)


def attend_chunked(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                   prefix_len: int = 0, q_chunk: int = 512,
                   kv_chunk: int = 1024, scale: float | None = None):
    """Flash-style online-softmax attention in plain torch, loops over
    chunks. For mask_kind == "local", each q chunk attends a static
    [qs - window, qs + q_chunk) KV slice; otherwise every KV chunk is
    visited and masked."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    n_kv = k.shape[2]
    g = h // n_kv
    scale = scale if scale is not None else dh ** -0.5
    q_chunk = math.gcd(sq, min(q_chunk, sq))
    kv_chunk = math.gcd(skv, min(kv_chunk, skv))
    nq, nk = sq // q_chunk, skv // kv_chunk
    pred = common.mask_fn(mask_kind, window, prefix_len)
    qg = _split_groups(q, n_kv).reshape(b, nq, q_chunk, n_kv, g, dh)
    dev = q.device
    outs = []

    if mask_kind == "local" and window and skv >= window + q_chunk:
        pad = window
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        for qi in range(nq):
            qc = qg[:, qi]                                       # b qc k g d
            qs = qi * q_chunk
            kc = kp[:, qs:qs + window + q_chunk]
            vc = vp[:, qs:qs + window + q_chunk]
            s = torch.einsum("bqkgd,bjkd->bkgqj", qc.float(),
                             kc.float()) * scale
            qpos = qs + torch.arange(q_chunk, device=dev)
            kpos = qs - pad + torch.arange(window + q_chunk, device=dev)
            m = pred(qpos[:, None], kpos[None, :]) & (kpos[None, :] >= 0)
            s = torch.where(m[None, None, None], s, -1e30)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgqj,bjkd->bqkgd", p.to(v.dtype), vc)
            outs.append(o.reshape(b, q_chunk, h, dh))
        return torch.cat(outs, dim=1)

    kc_all = k.reshape(b, nk, kv_chunk, n_kv, dh)
    vc_all = v.reshape(b, nk, kv_chunk, n_kv, dh)
    for qi in range(nq):
        qc = qg[:, qi]                                           # b qc k g d
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((b, n_kv, g, q_chunk), -math.inf, device=dev)
        l_run = torch.zeros((b, n_kv, g, q_chunk), device=dev)
        acc = torch.zeros((b, n_kv, g, q_chunk, dh), device=dev)
        for kj in range(nk):
            kc, vc = kc_all[:, kj], vc_all[:, kj]
            s = torch.einsum("bqkgd,bjkd->bkgqj", qc.float(),
                             kc.float()) * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = pred(qpos[:, None], kpos[None, :])
            s = torch.where(msk[None, None, None], s, -1e30)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            pv = torch.einsum("bkgqj,bjkd->bkgqd", p, vc.float())
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        o = acc / l_run.clamp(min=1e-30)[..., None]
        outs.append(o.movedim(3, 1).reshape(b, q_chunk, h, dh).to(q.dtype))
    return torch.cat(outs, dim=1)


def attend_decode(q, k_cache, v_cache, cache_len, *, window: int = 0,
                  prefix_len: int = 0, scale: float | None = None):
    """One-token decode vs a (B, Smax, K, Dh) cache. cache_len masks tail."""
    b, sq, h, dh = q.shape
    n_kv = k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = _split_groups(q, n_kv)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).expand(b)
    valid = kpos[None, :] < cache_len[:, None]
    if window:
        valid = valid & (kpos[None, :] >= cache_len[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, sq, h, dh)


def attend_flash(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                 prefix_len: int = 0):
    """The kernel front: exact attention for mask_kind "bidir" (Sq and
    Skv may differ: cross-attention), "causal", "local" (causal within
    `window`) or "prefix" (causal, and every key below `prefix_len`)
    through `kernels.ops.flash_attn` — q's heads folded into its batch,
    k/v read per group, not copied. `window` counts only for "local",
    `prefix_len` only for "prefix"."""
    if mask_kind not in ("bidir", "causal", "local", "prefix"):
        raise ValueError(f"mask_kind {mask_kind!r} is not an attention "
                         "mask (bidir, causal, local, prefix)")
    b, sq, h, dh = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    qf = q.movedim(2, 1).reshape(b * h, sq, dh)
    kf = k.movedim(2, 1).reshape(b * n_kv, skv, dh)
    vf = v.movedim(2, 1).reshape(b * n_kv, skv, dh)
    o = kops.flash_attn(qf, kf, vf, causal=mask_kind != "bidir",
                        window=window if mask_kind == "local" else 0,
                        prefix_len=prefix_len if mask_kind == "prefix" else 0)
    return o.reshape(b, h, sq, dh).movedim(1, 2)
