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
whose backward is the per-query-tile kernel in
csrc/mlp_softmax_attn_bwd.cu (dq and the tiles' partial dA, dU, du0 and
db1) plus plain products here for A = k^T w1 / sqrt(Dh), U = w2 @ v and
the gradients of k, v and the emulator weights; on CPU tensors the same
Function takes the plain versions `ref.mlp_softmax_attn` and
`ref.mlp_softmax_attn_bwd`. `bwd_work` counts what the backward kernel
must do.

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
_BWD_FN = {torch.float32: "mlp_softmax_attn_bwd_f32",
           torch.bfloat16: "mlp_softmax_attn_bwd_bf16"}
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
    f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch_bwd(q, k, v, w1, b1, w2, b2, do):
    """The gradients (dq, dk, dv, dw1, db1, dw2, db2) on CUDA tensors: the
    backward kernel for dq and the tiles' partials, then plain products
    for the rest. Sums over a kv head's group, the tiles and the heads
    are `torch.sum` over fixed axes (no atomics), so a second call is
    bitwise equal."""
    group = check_attention_operands("mlp_softmax_attn backward", q, k, v)
    bh, sq, dh = q.shape
    skv, hid = k.shape[1], w1.shape[-1]
    if do.shape != q.shape or dh not in HEAD_DIMS or not 1 <= hid <= HID_MAX:
        raise ValueError(f"mlp_softmax_attn backward kernel: do "
                         f"{tuple(do.shape)} against q {tuple(q.shape)}, "
                         f"head dim {dh} (in {HEAD_DIMS}), hid {hid} (in "
                         f"1..{HID_MAX})")
    # inputs made contiguous before any output is allocated
    q, do = q.contiguous(), do.to(q.dtype).contiguous()
    scale = dh ** -0.5
    a = (torch.matmul(k.float().transpose(-1, -2), w1.float()) * scale) \
        .contiguous()                                       # (BHk, Dh, hid)
    u = torch.matmul(w2.float(), v.float()).contiguous()    # (BHk, hid, Dh)
    nt = -(-sq // BQ)
    dq = torch.empty_like(q)
    da_p = torch.empty((bh, nt, dh, hid), dtype=torch.float32,
                       device=q.device)
    du_p = torch.empty((bh, nt, hid, dh), dtype=torch.float32,
                       device=q.device)
    du0_p = torch.empty((bh, nt, dh), dtype=torch.float32, device=q.device)
    db1_p = torch.empty((bh, nt, hid), dtype=torch.float32, device=q.device)
    b1c = b1.float().contiguous()
    err = _bwd_fn(q.dtype)(q.data_ptr(), do.data_ptr(), a.data_ptr(),
                           b1c.data_ptr(), u.data_ptr(), dq.data_ptr(),
                           da_p.data_ptr(), du_p.data_ptr(), du0_p.data_ptr(),
                           db1_p.data_ptr(), bh, group, sq, dh, hid,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_softmax_attn backward kernel launch "
                           f"failed: CUDA error {err}")
    _bwd_stats["kernel"] += 1
    return (dq, *bwd_products(k, v, w1, b1, w2, b2, da_p, du_p, du0_p, db1_p,
                              group))


def bwd_products(k, v, w1, b1, w2, b2, da_p, du_p, du0_p, db1_p, group: int):
    """(dk, dv, dw1, db1, dw2, db2) from the backward kernel's per-tile
    partials dA (BH, T, Dh, hid), dU (BH, T, hid, Dh), du0 (BH, T, Dh)
    and db1 (BH, T, hid): summed over each kv head's group and tiles (and
    db1 over every head), then dk = scale w1 dA^T, dw1 = scale sum k dA,
    dw2 = sum dU v^T, dv = w2^T dU + b2 du0, db2 = sum v du0, with plain
    products. Every sum is `torch.sum` or a product over fixed axes."""
    bh, nt, dh, hid = da_p.shape
    bhk, skv = bh // group, k.shape[1]
    kf, vf = k.float(), v.float()
    w1f, w2f, b2f = w1.float(), w2.float(), b2.float()
    scale = dh ** -0.5
    da = da_p.reshape(bhk, group * nt, dh, hid).sum(1)
    du = du_p.reshape(bhk, group * nt, hid, dh).sum(1)
    du0 = du0_p.reshape(bhk, group * nt, dh).sum(1)
    db1 = db1_p.sum((0, 1))
    dk = torch.matmul(w1f, da.transpose(-1, -2)) * scale
    dw1 = torch.matmul(kf.transpose(0, 1).reshape(skv, bhk * dh),
                       da.reshape(bhk * dh, hid)) * scale
    dw2 = torch.matmul(du.transpose(0, 1).reshape(hid, bhk * dh),
                       vf.transpose(-1, -2).reshape(bhk * dh, skv))
    dv = torch.matmul(w2f.t(), du) + b2f[:, None] * du0[:, None, :]
    db2 = torch.matmul(vf.transpose(0, 1).reshape(skv, bhk * dh),
                       du0.reshape(bhk * dh))
    return (dk.to(k.dtype), dv.to(v.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


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
