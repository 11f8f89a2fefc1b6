"""`rg_lru`: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t over
(B, T, D), from h_0 = 0 — the port of the Pallas kernel
repro/kernels/rg_lru.py:rg_lru_scan, as the CUDA kernel in
csrc/rg_lru.cu: a one-pass chunked scan, one block a batch row's 32
channels, its warps splitting each tile of time and passing their
chunks' carries through shared memory (`plan`). Float32 in, the float32
trace out; an initial state is folded into b_0 by the caller. `work`
counts what a call must do, for its bound on the card: bytes.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.rg_lru`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

LANES = 32               # channels a block: one a lane
WARPS = 4                # warps a block (csrc/rg_lru.cu)
STEPS = 16               # steps a warp a tile (csrc/rg_lru.cu)


def plan(t: int, d: int) -> tuple[int, int]:
    """(tiles, groups): a block walks T in tiles of WARPS x STEPS steps
    (warp w takes steps [w STEPS, (w + 1) STEPS) of each), and a batch
    row's D channels fall into groups of LANES, one block each."""
    return -(-t // (WARPS * STEPS)), -(-d // LANES)


def work(bsz: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one call, for its bound on the card: a
    multiply and an add a step of each channel; a and b read and h
    written once, float32."""
    n = bsz * t * d
    return 2.0 * n, 3.0 * n * 4


def _fn():
    f = build.lib("rg_lru").rg_lru_f32
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors a, b (B, T, D) float32."""
    refuse_grad("rg_lru", a, b)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("rg_lru kernel: operands must share one CUDA device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rg_lru kernel takes float32 a and b, got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rg_lru kernel: bad shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, want (B, T, D) twice")
    a = a if a.is_contiguous() else a.contiguous()
    b = b if b.is_contiguous() else b.contiguous()
    # the kernel writes h row-major, whatever the operands' strides were
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    bsz, t, d = a.shape
    err = _fn()(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, t, d,
                plan(t, d)[1],
                torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch failed: CUDA error {err}")
    _stats["kernel"] += 1
    return h


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0: (B, T, D) -> (B, T, D)
    float32."""
    if a.device.type == "cpu":
        _stats["ref"] += 1
        return ref.rg_lru(a, b)
    return launch(a, b)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
