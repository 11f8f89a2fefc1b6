"""`flash_attn`: exact online-softmax attention over (BH, S, Dh) — the port
of the Pallas kernel repro/kernels/flash_attn.py:flash_attn, as the CUDA
kernel in csrc/flash_attn.cu. Grouped-query attention passes k and v
with BH / group rows; the kernel reads kv head bh // group and never
repeats them. Float32 or bfloat16 in, float32 accumulation, q's dtype
out. A causal `window` w > 0 also masks keys k <= q - w (the "local"
mask), an addition of the port. Bound on the card: operations, on the
CUDA cores (see the source).

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

_FN = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _fn(dtype: torch.dtype):
    f = getattr(build.lib("flash_attn"), _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


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


def check_window(causal: bool, window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attn: a window ({window}) must be >= 0 "
                         "and needs causal attention")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int = 0) -> torch.Tensor:
    """Run the kernel on CUDA tensors q (BH, Sq, Dh), k/v (BH / group,
    Skv, Dh)."""
    group = check_attention_operands("flash_attn", q, k, v)
    check_window(causal, window)
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
                       int(causal), window, dh ** -0.5,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return o


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v per head; `causal` masks key j > query
    i and needs Sq == Skv; a `window` w > 0 also masks j <= i - w."""
    if q.device.type == "cpu":
        check_window(causal, window)
        _stats["ref"] += 1
        return ref.flash_attn(q, k, v, causal=causal, window=window)
    return launch(q, k, v, causal, window)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
