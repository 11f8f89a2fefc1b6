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

Gradients: when grad mode is on and an operand requires grad, the call
goes through `SsdScan`, a `torch.autograd.Function` whose forward is the
kernel and whose backward is the kernel in csrc/ssd_bwd.cu: dx, da, db,
dc and, when an initial state was given, its gradient, from dy and the
final state's gradient (when the final state is used), chunk-parallel on
the tensor cores in three launches (bf16 products, 3xTF32 for float32).
On CPU tensors the same Function takes the plain versions
`ref.ssd_chunked` and `ref.ssd_bwd`. `bwd_work` counts what the backward
must do.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain chunked scan `kernels.ref.ssd_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}
# the same for the backward kernel (`bwd_launches` a call)
_bwd_stats = {"kernel": 0, "ref": 0}

_FN = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
_BWD_FN = {torch.float32: "ssd_bwd_f32", torch.bfloat16: "ssd_bwd_bf16"}
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


BWD_CHUNK = 64           # steps a chunk of the backward (csrc/ssd_bwd.cu)
# the backward's scratch (csrc/ssd_bwd.cu, QT, HG, HG_F, IMG, IMG_F): heads
# a chunk-pass block, and the bytes of one chunk's S0 or dS image: bf16 a
# 64 x 128 tile image, hi and lo; float32 128 x 64 raw
BWD_HEADS = {torch.bfloat16: 5, torch.float32: 10}
BWD_IMAGE_BYTES = {torch.bfloat16: 2 * 64 * 128 * 2,
                   torch.float32: 128 * 64 * 4}


def bwd_launches(dtype: torch.dtype) -> int:
    """Kernels one backward call launches, in either type: the state
    pass, the chunk pass and the sum over head groups."""
    return 3


def bwd_work(bsz: int, t: int, h: int, p: int, n: int,
             dtype: torch.dtype) -> tuple[float, float]:
    """(operations, bytes) of one backward call: per chunk of q <=
    BWD_CHUNK steps of each (batch, head), the forward's state update
    recomputed (q P N), the causal triangles of C B^T and dY X^T (q (q +
    1) / 2 (N + P)), dX (q (q + 1) / 2 P + q N P), dB and dC (q (q + 1)
    / 2 N + q P N each) and the carried state gradient (q P N), at two
    operations a multiply-add; x, dy (and dx) at the element size, a
    and da float32, b, c (and db, dc) at the element size, each read or
    written once; no initial or final state."""
    e = dtype.itemsize
    macs = 0
    for t0 in range(0, t, BWD_CHUNK):
        q = min(BWD_CHUNK, t - t0)
        tri = q * (q + 1) // 2
        macs += q * p * n + tri * (n + p) + tri * p + q * n * p \
            + 2 * (tri * n + q * p * n) + q * p * n
    nbytes = 3 * bsz * t * h * p * e + 2 * bsz * t * h * 4 \
        + 4 * bsz * t * n * e
    return 2.0 * bsz * h * macs, float(nbytes)


_bwd_fns: dict = {}


def _bwd_fn(dtype: torch.dtype):
    f = _bwd_fns.get(dtype)
    if f is None:
        f = getattr(build.lib("ssd_bwd"), _BWD_FN[dtype])
        f.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _bwd_fns[dtype] = f
    return f


def launch_bwd(x, a, b, c, dy, dstate=None, state0=None):
    """Run the backward kernel on CUDA tensors: (dx, da, db, dc,
    dstate0) for the forward's operands, dy (B, T, H, P) in x's dtype
    and the final state's gradient (B, H, P, N) float32 or None;
    dstate0 is None without state0."""
    ops = (x, a, b, c, dy) + tuple(s for s in (dstate, state0)
                                   if s is not None)
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError("ssd backward kernel: operands must share one CUDA "
                         "device")
    if x.dtype not in _FN or any(t.dtype != x.dtype for t in (b, c, dy)) \
            or a.dtype != torch.float32 or any(
                s is not None and s.dtype != torch.float32
                for s in (dstate, state0)):
        raise TypeError(f"ssd backward kernel takes float32 or bfloat16 "
                        f"x/b/c/dy of one dtype and float32 a and states, "
                        f"got {x.dtype}, {a.dtype}, {b.dtype}, {c.dtype}, "
                        f"{dy.dtype}")
    bsz, t, h, p = x.shape if x.dim() == 4 else (0,) * 4
    n = b.shape[-1] if b.dim() == 3 else 0
    st = (bsz, h, p, n)
    if (x.dim() != 4 or a.shape != (bsz, t, h) or b.shape != (bsz, t, n)
            or c.shape != b.shape or dy.shape != x.shape
            or not 1 <= p <= MAX_HEAD_DIM or not 1 <= n <= MAX_STATE
            or any(s is not None and s.shape != st
                   for s in (dstate, state0))):
        raise ValueError(
            f"ssd backward kernel: bad shapes x {tuple(x.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, dy "
            f"{tuple(dy.shape)} (head dim <= {MAX_HEAD_DIM}, state <= "
            f"{MAX_STATE})")
    # inputs made contiguous before any output is allocated
    x, a, b, c, dy = (v.contiguous() for v in (x, a, b, c, dy))
    ds = None if dstate is None else dstate.contiguous()
    s0 = None if state0 is None else state0.contiguous()
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), \
        torch.empty_like(c)
    da = torch.empty_like(a)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if bsz * t * h == 0:
        for v in (dx, da, db, dc) + (() if ds0 is None else (ds0,)):
            v.zero_()
        if ds0 is not None and ds is not None:
            ds0.copy_(ds)              # no step: the state passes through
        return dx, da, db, dc, ds0
    nc = -(-t // BWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    # scratch: each chunk's S0 and dS images, and b's and c's gradients per
    # group of BWD_HEADS heads
    states = torch.empty(bsz * h * nc * 2 * BWD_IMAGE_BYTES[x.dtype],
                         dtype=torch.uint8, device=x.device)
    parts = -(-h // BWD_HEADS[x.dtype])
    dbh = torch.empty((bsz, parts, t, n), **f32)
    dch = torch.empty_like(dbh)

    def ptr(v):
        return None if v is None else v.data_ptr()
    err = _bwd_fn(x.dtype)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        dy.data_ptr(), ptr(ds), ptr(s0), dx.data_ptr(), da.data_ptr(),
        db.data_ptr(), dc.data_ptr(), ptr(ds0), states.data_ptr(),
        dbh.data_ptr(), dch.data_ptr(), bsz, h, t, p, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: CUDA error "
                           f"{err}")
    _bwd_stats["kernel"] += bwd_launches(x.dtype)
    return dx, da, db, dc, ds0


class SsdScan(torch.autograd.Function):
    """The kernel with its backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, a, b, c, state0, chunk: int):
        if x.device.type == "cpu":
            _stats["ref"] += 1
            y, s = ref.ssd_chunked(x, a, b, c, chunk, state0)
        else:
            y, s = launch(x, a, b, c, chunk, state0)
        ctx.save_for_backward(x, a, b, c, state0)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        x, a, b, c, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cpu":
            _bwd_stats["ref"] += 1
            dx, da, db, dc, ds0 = ref.ssd_bwd(x, a, b, c, dy, dstate, state0)
        else:
            dx, da, db, dc, ds0 = launch_bwd(x, a, b, c, dy, dstate, state0)
        return dx, da.to(a.dtype), db, dc, ds0, None


def ssd_chunked(x, a, b, c, *, chunk: int = MAX_CHUNK, state0=None):
    """Chunked SSD: y (B, T, H, P) in x's dtype and the final state
    (B, H, P, N) float32. Differentiable through the backward kernel
    (`SsdScan`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, b, c, state0)):
        return SsdScan.apply(x, a, b, c, state0, chunk)
    if x.device.type == "cpu":
        _stats["ref"] += 1
        return ref.ssd_chunked(x, a, b, c, chunk, state0)
    return launch(x, a, b, c, chunk, state0)


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
