"""`mlp_softmax_attn`: SelectFormer's MLP-emulated attention,
relu((q k^T / sqrt(Dh)) @ w1 + b1) @ (w2 @ v) + b2 @ v, without the
S x S probabilities — the port of the Pallas kernel
repro/kernels/mlp_softmax_attn.py:mlp_softmax_attn, as the CUDA kernel in
csrc/mlp_softmax_attn.cu. U = w2 @ v and u0 = b2 @ v are two plain
products here (the JAX package leaves both to XLA); the kernel computes A = k^T w1 / sqrt(Dh) first, one thread-block cluster a
head (`plan`), and then relu(q A + b1) @ U + u0. Grouped-query attention
passes k and v with BH / group rows. Float32 or bfloat16 q/k/v, float32
emulator weights with hid <= 64, Dh in {16, 32, 64, 128}, q's dtype out.
`work` counts what a call must do, for its bound on the card: bytes.

Gradients: when grad mode is on and an input requires grad, the call
goes through a `torch.autograd.Function` whose forward is the kernel and
whose backward is two kernels in csrc/mlp_softmax_attn_bwd.cu: one
thread-block cluster a kv head (`bwd_plan`) computes A, U, dq, dk, dv
and the head's partials of the emulator weights' gradients, and a second
launch sums those over the heads; on CPU tensors the same Function takes
the plain versions `ref.mlp_softmax_attn` and `ref.mlp_softmax_attn_bwd`.
`bwd_work` counts what the backward must do.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.mlp_softmax_attn`, which
materializes the probabilities.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import check_attention_operands

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

# launches of the backward kernel and calls of its plain version
_bwd_stats = {"kernel": 0, "ref": 0}

_FN = {torch.float32: "mlp_softmax_attn_f32",
       torch.bfloat16: "mlp_softmax_attn_bf16"}
_BWD_FN = {torch.float32: "msa_bwd_heads_f32",
           torch.bfloat16: "msa_bwd_heads_bf16"}
HID_MAX = 64
HEAD_DIMS = (16, 32, 64, 128)
BQ = 64                  # query rows a tile (csrc/mlp_softmax_attn.cu)
CLUSTER_MAX = 8          # blocks a cluster, the portable most


def plan(sq: int, skv: int) -> tuple[int, int]:
    """(C, L): a head's cluster holds C blocks, one a 64-row query tile up
    to 8 (block r then walks tiles r, r + C, ...), and block r reduces
    key rows [r L, min(Skv, (r + 1) L))."""
    c = max(1, min(CLUSTER_MAX, -(-sq // BQ)))
    return c, -(-skv // c)


def bwd_plan(bhk: int, group: int, sq: int, skv: int,
             sms: int) -> tuple[int, int]:
    """(C, L) of the backward's head pass on a card of `sms` SMs: each of
    the BHk kv heads gets a cluster of C blocks, block r walking the
    head's (q head of the group, 64-row query tile) work items r, r + C,
    ... and owning key rows [r L, min(Skv, (r + 1) L)). C is the largest
    power of two up to 8 and up to the work items with BHk C <= 2 SMs (two
    blocks share a SM on the in-vivo path): the head pass then runs in one
    wave where the heads allow, since a block's phases, not its work, set
    its time (PERF.md)."""
    items = group * -(-sq // BQ)
    c = 1
    while 2 * c <= min(CLUSTER_MAX, items) and bhk * 2 * c <= 2 * sms:
        c *= 2
    return c, -(-skv // c)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_scratch(skv: int, hid: int) -> int:
    """Floats a kv head's row of the backward's weight partials takes:
    dw1 (Skv, hid), dw2 (hid, Skv), db2 (Skv) and db1 (hid), padded to a
    multiple of 4 (16 bytes)."""
    return -(-(2 * skv * hid + skv + hid) // 4) * 4


def work(bh: int, group: int, sq: int, skv: int, dh: int, hid: int,
         dtype: torch.dtype) -> tuple[float, float]:
    """(bytes, operations) of one call, for its bound on the card: q, k,
    v and out at the element size and w1, b1, w2, b2 in float32, each
    read or written once; two operations a multiply-add for
    A = k^T w1 (once a kv head), q A and H U (once a q head) and the
    wrapper's w2 @ v and b2 @ v (once a kv head)."""
    e, bhk = dtype.itemsize, bh // group
    nbytes = (2 * bh * sq * dh + 2 * bhk * skv * dh) * e \
        + (2 * skv * hid + hid + skv) * 4
    ops = 2.0 * (bhk * skv * dh * hid + 2 * bh * sq * dh * hid
                 + bhk * (hid + 1) * skv * dh)
    return float(nbytes), ops


def bwd_work(bh: int, group: int, sq: int, skv: int, dh: int, hid: int,
             dtype: torch.dtype) -> tuple[float, float]:
    """(bytes, operations) of one backward call (`launch_bwd`), for its
    bound: q, do, dq and k, v, dk, dv at the element size, and w1, b1,
    w2, b2 and their gradients in float32, each read or written once; two
    operations a multiply-add for q A, do U^T, dZ A^T, H^T do and q^T dZ
    (once a q head) and for A, U, dk, dw1, dw2 and dv (once a kv head)."""
    e, bhk = dtype.itemsize, bh // group
    nbytes = (3 * bh * sq * dh + 4 * bhk * skv * dh) * e \
        + 2 * (2 * skv * hid + hid + skv) * 4
    ops = 2.0 * (5 * bh * sq * dh * hid + 6 * bhk * skv * dh * hid)
    return float(nbytes), ops


@functools.cache
def _fn(dtype: torch.dtype):
    f = getattr(build.lib("mlp_softmax_attn"), _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, starting on a 16-byte boundary (the kernel's copies
    are 16 bytes)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch(q, k, v, w1, b1, w2, b2) -> torch.Tensor:
    """Run the kernel on CUDA tensors q (BH, Sq, Dh), k/v (BH / group,
    Skv, Dh), w1 (Skv, hid), b1 (hid,), w2 (hid, Skv), b2 (Skv,)."""
    group = check_attention_operands("mlp_softmax_attn", q, k, v)
    skv, hid = k.shape[1], w1.shape[-1]
    ws = (w1, b1, w2, b2)
    if not all(w.device == q.device for w in ws):
        raise ValueError("mlp_softmax_attn kernel: weights must be on q's "
                         "device")
    if (w1.shape != (skv, hid) or b1.shape != (hid,)
            or w2.shape != (hid, skv) or b2.shape != (skv,)
            or not 1 <= hid <= HID_MAX or q.shape[2] not in HEAD_DIMS):
        raise ValueError(f"mlp_softmax_attn kernel: bad emulator shapes "
                         f"{[tuple(w.shape) for w in ws]} for Skv {skv} "
                         f"(hid in 1..{HID_MAX}) or head dim {q.shape[2]} "
                         f"(in {HEAD_DIMS})")
    bh, sq, dh = q.shape
    if q.numel() == 0:
        return torch.empty_like(q)
    # q first: the kernel writes o as one contiguous (BH, Sq, Dh) array
    q, k = _aligned(q), _aligned(k)
    o = torch.empty_like(q)
    vf = v.float()
    u = torch.matmul(w2.float(), vf).contiguous()          # (BHk, hid, Dh)
    u0 = torch.matmul(b2.float(), vf).contiguous()         # (BHk, Dh)
    w1, b1 = w1.float().contiguous(), b1.float().contiguous()
    nc, slice_ = plan(sq, skv)
    err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), w1.data_ptr(),
                       b1.data_ptr(), u.data_ptr(), u0.data_ptr(),
                       o.data_ptr(), bh, group, sq, skv, dh, hid, nc, slice_,
                       dh ** -0.5,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_softmax_attn kernel launch failed: CUDA "
                           f"error {err}")
    _stats["kernel"] += 1
    return o


@functools.cache
def _bwd_fn(dtype: torch.dtype):
    f = getattr(build.lib("mlp_softmax_attn_bwd"), _BWD_FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


@functools.cache
def _sum_fn():
    f = build.lib("mlp_softmax_attn_bwd").msa_bwd_sum
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch_bwd(q, k, v, w1, b1, w2, b2, do):
    """The gradients (dq, dk, dv, dw1, db1, dw2, db2) on CUDA tensors, in
    two launches: the head pass (one cluster a kv head: dq, dk, dv and the
    head's partials of dw1, dw2, db2, db1) and the sum of those partials
    over the heads. Every sum runs in a fixed order (no atomics), so a
    second call is bitwise equal."""
    group = check_attention_operands("mlp_softmax_attn backward", q, k, v)
    bh, sq, dh = q.shape
    skv, hid = k.shape[1], w1.shape[-1]
    if do.shape != q.shape or dh not in HEAD_DIMS or not 1 <= hid <= HID_MAX:
        raise ValueError(f"mlp_softmax_attn backward kernel: do "
                         f"{tuple(do.shape)} against q {tuple(q.shape)}, "
                         f"head dim {dh} (in {HEAD_DIMS}), hid {hid} (in "
                         f"1..{HID_MAX})")
    # inputs made contiguous and aligned before any output is allocated
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    do = _aligned(do.to(q.dtype))
    w1, b1, w2, b2 = (w.float().contiguous() for w in (w1, b1, w2, b2))
    bhk = bh // group
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    ns4 = bwd_scratch(skv, hid)
    part = torch.empty((bhk, ns4), dtype=torch.float32, device=q.device)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1, db2 = torch.empty_like(b1), torch.empty_like(b2)
    nc, slice_ = bwd_plan(bhk, group, sq, skv, _sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn(q.dtype)(q.data_ptr(), do.data_ptr(), k.data_ptr(),
                           v.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), b2.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), part.data_ptr(), bh,
                           group, sq, skv, dh, hid, nc, slice_, ns4,
                           dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"mlp_softmax_attn backward head pass launch "
                           f"failed: CUDA error {err}")
    _bwd_stats["kernel"] += 1
    err = _sum_fn()(part.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
                    db2.data_ptr(), db1.data_ptr(), bhk, skv, hid, ns4,
                    stream)
    if err != 0:
        raise RuntimeError(f"mlp_softmax_attn backward head sum launch "
                           f"failed: CUDA error {err}")
    _bwd_stats["kernel"] += 1
    return dq, dk, dv, dw1, db1, dw2, db2


class MlpSoftmaxAttn(torch.autograd.Function):
    """The kernel with its backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, w1, b1, w2, b2):
        if q.device.type == "cpu":
            _stats["ref"] += 1
            o = ref.mlp_softmax_attn(q, k, v, w1, b1, w2, b2)
        else:
            o = launch(q, k, v, w1, b1, w2, b2)
        ctx.save_for_backward(q, k, v, w1, b1, w2, b2)
        return o

    @staticmethod
    def backward(ctx, do):
        args = ctx.saved_tensors
        if args[0].device.type == "cpu":
            _bwd_stats["ref"] += 1
            return ref.mlp_softmax_attn_bwd(*args, do)
        return launch_bwd(*args, do)


def mlp_softmax_attn(q, k, v, w1, b1, w2, b2) -> torch.Tensor:
    """MLP_sm attention: probs = relu(S @ w1 + b1) @ w2 + b2 over the
    scores S = q k^T / sqrt(Dh), out = probs @ v. Differentiable through
    the backward kernel (`MlpSoftmaxAttn`)."""
    args = (q, k, v, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return MlpSoftmaxAttn.apply(*args)
    if q.device.type == "cpu":
        _stats["ref"] += 1
        return ref.mlp_softmax_attn(*args)
    return launch(*args)


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
