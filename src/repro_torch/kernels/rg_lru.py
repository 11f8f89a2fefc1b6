"""`rg_lru`: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t over
(B, T, D), from h_0 = 0 — the port of the Pallas kernel
repro/kernels/rg_lru.py:rg_lru_scan, as the CUDA kernel in
csrc/rg_lru.cu: a one-pass chunked scan, one block a batch row's 32
channels, its warps splitting each tile of time and passing their
chunks' carries through shared memory (`plan`). Float32 in, the float32
trace out; an initial state is folded into b_0 by the caller. `work`
counts what a call must do, for its bound on the card: bytes.

Gradients: when grad mode is on and a or b requires grad, the call goes
through `RgLru`, a `torch.autograd.Function` whose forward is the kernel
and whose backward is the kernel in csrc/rg_lru_bwd.cu (the reverse
recurrence g_t = dh_t + a_{t+1} g_{t+1}, db = g, da_t = g_t h_{t-1}, from
the forward's saved trace); on CPU tensors the same Function takes the
plain versions `ref.rg_lru` and `ref.rg_lru_bwd`. `bwd_work` counts what
the backward must do: bytes.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.rg_lru`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}
# the same for the backward kernel
_bwd_stats = {"kernel": 0, "ref": 0}

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


def bwd_work(bsz: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one backward call: a multiply-add for g and
    a multiply for da a step of each channel; a, h and dh read and da
    and db written once, float32."""
    n = bsz * t * d
    return 3.0 * n, 5.0 * n * 4


def _fn():
    f = build.lib("rg_lru").rg_lru_f32
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors a, b (B, T, D) float32."""
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


_bwd_fn = None


def launch_bwd(a: torch.Tensor, h: torch.Tensor,
               dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the backward kernel on CUDA tensors a, h, dh (B, T, D) float32
    (h the forward's trace): (da, db) float32."""
    global _bwd_fn
    if not all(t.is_cuda and t.device == a.device for t in (a, h, dh)):
        raise ValueError("rg_lru backward kernel: operands must share one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in (a, h, dh)):
        raise TypeError(f"rg_lru backward kernel takes float32 a, h and dh, "
                        f"got {a.dtype}, {h.dtype}, {dh.dtype}")
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"rg_lru backward kernel: bad shapes a "
                         f"{tuple(a.shape)}, h {tuple(h.shape)}, dh "
                         f"{tuple(dh.shape)}, want (B, T, D) thrice")
    # inputs made contiguous before the outputs are allocated
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    if da.numel() == 0:
        return da, db
    if _bwd_fn is None:
        _bwd_fn = build.lib("rg_lru_bwd").rg_lru_bwd_f32
        _bwd_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        _bwd_fn.restype = ctypes.c_int
    bsz, t, d = a.shape
    err = _bwd_fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                  db.data_ptr(), bsz, t, d,
                  torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru backward kernel launch failed: CUDA "
                           f"error {err}")
    _bwd_stats["kernel"] += 1
    return da, db


class RgLru(torch.autograd.Function):
    """The kernel with its backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, a, b):
        if a.device.type == "cpu":
            _stats["ref"] += 1
            h = ref.rg_lru(a, b)
        else:
            h = launch(a, b)
        ctx.save_for_backward(a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        if a.device.type == "cpu":
            _bwd_stats["ref"] += 1
            da, db = ref.rg_lru_bwd(a, h, dh)
        else:
            da, db = launch_bwd(a, h, dh)
        return da.to(a.dtype), db.to(ctx.b_dtype)


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0: (B, T, D) -> (B, T, D)
    float32. Differentiable through the backward kernel (`RgLru`)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RgLru.apply(a, b)
    if a.device.type == "cpu":
        _stats["ref"] += 1
        return ref.rg_lru(a, b)
    return launch(a, b)


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
