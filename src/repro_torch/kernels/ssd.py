"""`ssd`: the Mamba-2 chunked state-space scan — the port of the Pallas
kernel repro/kernels/ssd.py:ssd_chunked (with its layout adapter
repro/kernels/ops.py:ssd_chunked), as the CUDA kernel in csrc/ssd.cu.
It takes the model's layout, x (B, T, H, P), a (B, T, H) float32 log
decays, b/c (B, T, N), so no transpose precedes it, and returns y in x's
dtype and the final state (B, H, P, N) float32, from an optional initial
state. x, b and c are float32 or bfloat16 (one dtype). The products run on
Hopper's tensor cores (`wgmma`: bf16, 3xTF32 for float32) with float32
accumulation, and the state stays float32. Chunks of up to 128 steps; T
need not divide by the chunk. `work` counts what a call must do, for its
bound on the card: bytes in bfloat16 (see the source).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain chunked scan `kernels.ref.ssd_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

_FN = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


def work(bsz: int, t: int, h: int, p: int, n: int, chunk: int,
         dtype: torch.dtype, state0: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one call, for its bound on the card: per
    chunk of q steps (the last one ragged) the causal triangle of C B^T
    and its product with X, q (q + 1) / 2 (N + P) multiply-adds, and the
    state read and update, 2 q P N, at two operations a multiply-add; x
    and y at the element size, a, b and c, the final state (and the
    initial one if given) each read or written once."""
    e = dtype.itemsize
    macs = 0
    for t0 in range(0, t, chunk):
        q = min(chunk, t - t0)
        macs += q * (q + 1) // 2 * (n + p) + 2 * q * p * n
    nbytes = (2 * bsz * t * h * p * e + bsz * t * h * 4 + 2 * bsz * t * n * e
              + (2 if state0 else 1) * bsz * h * p * n * 4)
    return 2.0 * bsz * h * macs, float(nbytes)


def _fn(dtype: torch.dtype):
    f = getattr(build.lib("ssd"), _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(x, a, b, c, chunk: int = MAX_CHUNK, state0=None):
    """Run the kernel on CUDA tensors; returns (y, final state)."""
    refuse_grad("ssd", x, a, b, c, state0)
    ops = (x, a, b, c) + (() if state0 is None else (state0,))
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError("ssd kernel: operands must share one CUDA device")
    if x.dtype not in _FN or b.dtype != x.dtype or c.dtype != x.dtype \
            or a.dtype != torch.float32 \
            or (state0 is not None and state0.dtype != torch.float32):
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x/b/c of one "
                        f"dtype and float32 a and state, got {x.dtype}, "
                        f"{a.dtype}, {b.dtype}, {c.dtype}")
    bsz, t, h, p = x.shape if x.dim() == 4 else (0,) * 4
    n = b.shape[-1] if b.dim() == 3 else 0
    if (x.dim() != 4 or a.shape != (bsz, t, h) or b.shape != (bsz, t, n)
            or c.shape != b.shape or not 1 <= p <= MAX_HEAD_DIM
            or not 1 <= n <= MAX_STATE
            or (state0 is not None and state0.shape != (bsz, h, p, n))):
        raise ValueError(
            f"ssd kernel: bad shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {tuple(c.shape)} (head dim <= "
            f"{MAX_HEAD_DIM}, state <= {MAX_STATE})")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd kernel: chunk {chunk} not in [1, {MAX_CHUNK}]")
    x, a, b, c = x.contiguous(), a.contiguous(), b.contiguous(), \
        c.contiguous()
    s0 = None if state0 is None else state0.contiguous()
    y = torch.empty_like(x)
    s_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz * h == 0:
        return y, s_out
    err = _fn(x.dtype)(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       None if s0 is None else s0.data_ptr(), y.data_ptr(),
                       s_out.data_ptr(), bsz, h, t, chunk, p, n,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    _stats["kernel"] += 1
    return y, s_out


def ssd_chunked(x, a, b, c, *, chunk: int = MAX_CHUNK, state0=None):
    """Chunked SSD: y (B, T, H, P) in x's dtype and the final state
    (B, H, P, N) float32."""
    if x.device.type == "cpu":
        _stats["ref"] += 1
        return ref.ssd_chunked(x, a, b, c, chunk, state0)
    return launch(x, a, b, c, chunk, state0)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
