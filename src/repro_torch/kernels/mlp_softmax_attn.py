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

_FN = {torch.float32: "mlp_softmax_attn_f32",
       torch.bfloat16: "mlp_softmax_attn_bf16"}
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


def mlp_softmax_attn(q, k, v, w1, b1, w2, b2) -> torch.Tensor:
    """MLP_sm attention: probs = relu(S @ w1 + b1) @ w2 + b2 over the
    scores S = q k^T / sqrt(Dh), out = probs @ v."""
    if q.device.type == "cpu":
        _stats["ref"] += 1
        return ref.mlp_softmax_attn(q, k, v, w1, b1, w2, b2)
    return launch(q, k, v, w1, b1, w2, b2)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
