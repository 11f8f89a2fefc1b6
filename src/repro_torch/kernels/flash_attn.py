"""`flash_attn`: exact online-softmax attention over (BH, S, Dh) — the port
of the Pallas kernel repro/kernels/flash_attn.py:flash_attn, as the CUDA
kernel in csrc/flash_attn.cu, on Hopper's tensor cores (`wgmma`: bf16
products for bfloat16, 3xTF32 for float32). Grouped-query attention
passes k and v with BH / group rows; the kernel reads kv head bh // group
and never repeats them. Float32 or bfloat16 in, float32 accumulation,
q's dtype out. A causal `window` w > 0 also masks keys k <= q - w (the
"local" mask), an addition of the port; a causal `prefix_len` P > 0
keeps every key k < P as well (the "prefix" mask of a VLM's image
tokens; not with a window). `work` counts what a call must do, for its
bound on the card: bytes in bfloat16, operations in float32.

Gradients: when grad mode is on and q, k or v requires grad, the call
goes through a `torch.autograd.Function` whose forward is the kernel and
whose backward is the backward kernel in csrc/flash_attn_bwd.cu, in two
launches: dq with each row's lse and D, then dk and dv. It is
FlashAttention-2's backward on the tensor cores (`wgmma` like the
forward; 3xTF32 for float32) at every Dh; at Dh 256 the dk/dv pass
splits into a dk and a dv pass of one launch, one q head a block, and a
third launch sums dk and dv over each kv head's group. In float32 at Dh
256, where a pass's blocks would not fill the card, each block walks a
part of its keys (dq) or queries (dk, dv), `bwd_splits`, the dq parts
combined by a fourth launch.
Every mask of the forward has its
backward: bidir (Sq and Skv may differ), causal, local (a window) and
prefix. On CPU tensors the same Function takes the plain versions
`ref.flash_attn` and `ref.flash_attn_bwd`. `bwd_work` counts what the
backward must do: operations in either type, its bound on the card.
Only causal attention with Sq != Skv, which the forward refuses too, has
no backward.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.flash_attn`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

# launches of the backward kernels (each call launches two: dq, then dk
# and dv) and calls of their plain version
_bwd_stats = {"kernel": 0, "ref": 0}

_FN = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}
_BWD_FN = {torch.float32: "flash_attn_bwd_f32",
           torch.bfloat16: "flash_attn_bwd_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)


_fns: dict = {}


def _fn(dtype: torch.dtype):
    """The kernel's C entry point for `dtype`, typed once and kept: the
    call sits on every attention layer's path."""
    f = _fns.get(dtype)
    if f is None:
        f = getattr(build.lib("flash_attn"), _FN[dtype])
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[dtype] = f
    return f


def kept_pairs(sq: int, skv: int, causal: bool, window: int = 0,
               prefix_len: int = 0) -> int:
    """(query, key) pairs the mask keeps: all Sq * Skv, or causal key
    j <= query i (Sq == Skv), and with a window w > 0 also j > i - w, or
    with a prefix P > 0 j <= i or j < P: sum over i of max(i + 1, P)."""
    if not causal:
        return sq * skv
    if prefix_len:
        p = min(prefix_len, sq)
        return p * p + sq * (sq + 1) // 2 - p * (p + 1) // 2
    w = window if 0 < window < sq else sq
    return w * (w + 1) // 2 + (sq - w) * w


def work(q_shape, kv_heads: int, dtype: torch.dtype, causal: bool,
         window: int = 0, skv: int | None = None,
         prefix_len: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one call on q (BH, Sq, Dh) and k/v
    (kv_heads, Skv, Dh), Skv = Sq unless given: two products of Dh
    multiply-adds over each kept (query, key) pair, and q, k, v read and
    o written once each at the dtype's element size."""
    bh, sq, dh = q_shape
    skv = sq if skv is None else skv
    e = torch.empty((), dtype=dtype).element_size()
    ops = 4.0 * bh * kept_pairs(sq, skv, causal, window, prefix_len) * dh
    return ops, float((2 * bh * sq + 2 * kv_heads * skv) * dh * e)


def bwd_work(q_shape, kv_heads: int, dtype: torch.dtype, causal: bool,
             window: int = 0, prefix_len: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one backward call on q (BH, S, Dh): five
    products of Dh multiply-adds over each kept pair (S, dP, dq, dk,
    dv), and q, k, v, o, do read and dq, dk, dv written once each at the
    dtype's element size."""
    bh, s, dh = q_shape
    e = torch.empty((), dtype=dtype).element_size()
    ops = 10.0 * bh * kept_pairs(s, s, causal, window, prefix_len) * dh
    return ops, float((4 * bh * s + 4 * kv_heads * s) * dh * e)


def check_attention_operands(name: str, q, k, v) -> int:
    """Validate q (BH, Sq, Dh), k/v (BH / group, Skv, Dh) on one CUDA
    device in one supported dtype; returns the group size."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name} kernel: operands must share one CUDA "
                         "device")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or k.shape[2] != q.shape[2] or q.shape[2] not in HEAD_DIMS
            or k.shape[0] == 0 or q.shape[0] % k.shape[0]):
        raise ValueError(f"{name} kernel: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (head "
                         f"dim in {HEAD_DIMS})")
    return q.shape[0] // k.shape[0]


def check_window(causal: bool, window: int, prefix_len: int = 0) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attn: a window ({window}) must be >= 0 "
                         "and needs causal attention")
    if prefix_len < 0 or (prefix_len and (not causal or window)):
        raise ValueError(f"flash_attn: a prefix ({prefix_len}) must be >= 0 "
                         "and needs causal attention without a window")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int = 0,
           prefix_len: int = 0) -> torch.Tensor:
    """Run the kernel on CUDA tensors q (BH, Sq, Dh), k/v (BH / group,
    Skv, Dh)."""
    group = check_attention_operands("flash_attn", q, k, v)
    check_window(causal, window, prefix_len)
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("flash_attn kernel: causal attention needs "
                         f"Sq == Skv, got {q.shape[1]} and {k.shape[1]}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, sq, dh = q.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), bh, group, sq, k.shape[1], dh,
                       int(causal), window, prefix_len, dh ** -0.5,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return o


_bwd_fns: dict = {}


def _bwd_fn(dtype: torch.dtype):
    f = _bwd_fns.get(dtype)
    if f is None:
        f = getattr(build.lib("flash_attn_bwd"), _BWD_FN[dtype])
        f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _bwd_fns[dtype] = f
    return f


def check_bwd(q, k, causal: bool) -> None:
    """Refuse what the backward kernel does not take (it never hands back
    a plain gradient instead): causal attention with Sq != Skv, which
    the forward refuses too."""
    if q.shape[2] not in BWD_HEAD_DIMS or (causal
                                           and q.shape[1] != k.shape[1]):
        raise ValueError(
            f"flash_attn backward kernel: head dim {q.shape[2]} (takes "
            f"{BWD_HEAD_DIMS}) or causal Sq {q.shape[1]} != Skv "
            f"{k.shape[1]}")


def bwd_splits(dtype: torch.dtype, bh: int, sq: int, skv: int,
               sms: int) -> tuple[int, int]:
    """(dq parts, dk/dv parts) of the float32 Dh-256 backward on a card
    of `sms` SMs: each pass's block walks one of that many contiguous
    parts of its key tiles (dq: a part writes dq~ with its rows' max and
    sum, which a fourth launch combines in part order) or query tiles
    (dk, dv: a part writes its own float32 partial, which the group sum
    adds in order). As many parts as keep a pass's blocks (a q head's 64
    rows, two of them in the dk/dv launch) within two for each SM, at
    most 4; bf16 walks whole."""
    if dtype != torch.float32:
        return 1, 1
    def parts(blocks):
        return max(1, min(4, 2 * sms // blocks))
    return parts(bh * -(-sq // 64)), parts(2 * bh * -(-skv // 64))


def bwd_launches(dh: int, nsq: int = 1) -> int:
    """Kernels one backward call launches: the dq pass and the dk/dv
    pass; at Dh 256 the group sum too, and the combine of `nsq` > 1 dq
    parts."""
    return 2 if dh != 256 else 3 + (nsq > 1)


_sms: dict = {}


def _sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def launch_bwd(q, k, v, o, do, causal: bool, window: int = 0,
               prefix_len: int = 0):
    """Run the backward kernel on CUDA tensors: (dq, dk, dv) for q
    (BH, Sq, Dh), k/v (BH / group, Skv, Dh), the forward's o and its
    gradient do; dk and dv sum over each kv head's group."""
    group = check_attention_operands("flash_attn backward", q, k, v)
    check_window(causal, window, prefix_len)
    check_bwd(q, k, causal)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attn backward kernel: o {tuple(o.shape)} "
                         f"and do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    # inputs made contiguous before any output is allocated: the kernel
    # reads and writes each as one (rows, Dh) array
    q, k, v, o = q.contiguous(), k.contiguous(), v.contiguous(), \
        o.contiguous()
    do = do.to(q.dtype).contiguous()
    bh, sq, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # each row's log-sum-exp (base 2) and D = rowsum(do * o), from the dq
    # kernel to the dk/dv kernel
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    # Dh 256: each q head's dk and dv in float32 (a partial for each part
    # of its query walk), summed over the group by the third launch; then
    # the dq pass's parts with their rows' max and sum, if it has more
    # than one
    nsq, nspl = bwd_splits(q.dtype, bh, sq, k.shape[1],
                           _sm_count(q.device)) if dh == 256 else (1, 1)
    part = torch.empty(2 * bh * nspl * k.shape[1] * dh
                       + (nsq * bh * sq * (dh + 2) if nsq > 1 else 0),
                       dtype=torch.float32,
                       device=q.device) if dh == 256 else None
    err = _bwd_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                           dsum.data_ptr(),
                           None if part is None else part.data_ptr(),
                           bh, group, nsq, nspl, sq, k.shape[1], dh,
                           int(causal), window, prefix_len, dh ** -0.5,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn backward kernel launch failed: CUDA "
                           f"error {err}")
    # the dq kernel, then the dk/dv one (and at Dh 256 the group sum, and
    # the dq parts' combine where there are parts)
    _bwd_stats["kernel"] += bwd_launches(dh, nsq)
    return dq, dk, dv


class FlashAttn(torch.autograd.Function):
    """The kernel with its backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                prefix_len: int = 0):
        if q.device.type == "cpu":
            _stats["ref"] += 1
            o = ref.flash_attn(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)
        else:
            o = launch(q, k, v, causal, window, prefix_len)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.prefix_len = causal, window, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if q.device.type == "cpu":
            _bwd_stats["ref"] += 1
            grads = ref.flash_attn_bwd(q, k, v, o, do, causal=ctx.causal,
                                       window=ctx.window,
                                       prefix_len=ctx.prefix_len)
        else:
            grads = launch_bwd(q, k, v, o, do, ctx.causal, ctx.window,
                               ctx.prefix_len)
        return (*grads, None, None, None)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               prefix_len: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v per head; `causal` masks key j > query
    i and needs Sq == Skv; a `window` w > 0 also masks j <= i - w; a
    `prefix_len` P > 0 keeps j < P (no window). Differentiable through the
    backward kernel (`FlashAttn`)."""
    check_window(causal, window, prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_bwd(q, k, causal)
        return FlashAttn.apply(q, k, v, causal, window, prefix_len)
    if q.device.type == "cpu":
        _stats["ref"] += 1
        return ref.flash_attn(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len)
    return launch(q, k, v, causal, window, prefix_len)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def bwd_stats() -> dict:
    return dict(_bwd_stats)


def reset_bwd_stats() -> None:
    for k in _bwd_stats:
        _bwd_stats[k] = 0
