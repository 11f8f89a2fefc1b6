"""`entropy_head`: per-row softmax entropy of logits (R, V) in one pass,
H = m + log z - s / z — the port of the Pallas kernel
repro/kernels/entropy_head.py:entropy_head, as the CUDA kernel in
csrc/entropy_head.cu (one warp a row). Float32, bfloat16 or float16 in,
float32 (R,) out. Bound on the card: bytes.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.entropy_head`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

_FN = {torch.float32: "entropy_head_f32", torch.bfloat16: "entropy_head_bf16",
       torch.float16: "entropy_head_f16"}


def _fn(dtype: torch.dtype):
    f = getattr(build.lib("entropy_head"), _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(logits: torch.Tensor) -> torch.Tensor:
    """Run the kernel on a CUDA tensor of logits (R, V)."""
    if not logits.is_cuda:
        raise ValueError("entropy_head kernel: logits must be on a CUDA "
                         "device")
    if logits.dtype not in _FN:
        raise TypeError(f"entropy_head kernel takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"entropy_head kernel: logits of shape "
                         f"{tuple(logits.shape)}, want (R, V) with V > 0")
    x = logits.contiguous()
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    err = _fn(x.dtype)(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"entropy_head kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return out


def entropy_head(logits: torch.Tensor) -> torch.Tensor:
    """Softmax entropy of each row: (R, V) -> (R,) float32."""
    if logits.device.type == "cpu":
        _stats["ref"] += 1
        return ref.entropy_head(logits)
    return launch(logits)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
