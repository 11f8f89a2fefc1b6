"""`secure_matmul`: both parties' Beaver post-open combine in one launch,

  z_p = c_p + eps @ b_p + a_p @ dlt   (+ party 0 only: eps @ dlt)

on int32 (RING32) and int64 (RING64), with an optional batch — the port
of the Pallas kernel repro/kernels/secure_matmul.py:secure_matmul, as
the CUDA kernel in csrc/secure_matmul.cu behind a torch custom op. Each
party's combine is one ring product over a K twice as long, z_p = c_p +
[eps | a_p] @ [b'_p ; dlt] with b'_0 = b_0 + dlt (wrapping) and b'_1 =
b_1, run on the int8 tensor cores as ring_matmul's is: both halves'
`limb_pairs` u8 products issue into the same diagonals, so a diagonal
folds every `K_CHUNK` elements of K, half of ring_matmul's. The opened
eps/dlt tiles are loaded once for both parties. Bound on the card:
`work` (see the source's note).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version (`secure_matmul_plain`, built on
kernels/ref.py:secure_matmul_combine); a meta tensor takes the fake
impl. Under `torch.func.vmap` the vmap rule folds the vmapped dim into
the kernel's batch: one launch per wave.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import secure_matmul_combine
from repro_torch.kernels.ring_matmul import batched_operand, limb_pairs

# launches of the kernel ("kernel"), plain-version calls on CPU tensors
# ("ref"); "padded" stays 0 — the kernel masks ragged tiles itself, so no
# host padding exists (the key is kept for the JAX package's report)
_stats = {"kernel": 0, "ref": 0, "padded": 0}

_FN = {torch.int32: "secure_matmul_i32", torch.int64: "secure_matmul_i64"}
# elements of K a diagonal sums in s32 before the kernel folds it (K_CHUNK_I32
# / K_CHUNK_I64 in the source): each element of K adds two limb products
# to a diagonal, 2 (s + 1) 255**2 K_CHUNK < 2**31 for every diagonal s < L
K_CHUNK = {torch.int32: 4096, torch.int64: 2048}


def work(batch: int, m: int, k: int, n: int, dtype: torch.dtype,
         broadcast_b: bool = False) -> tuple[float, float, float]:
    """(u8 limb operations, ring operations, bytes) of one call: four
    ring products of 2 m n k (each party's combine over 2 k), as the
    CUDA cores would multiply-add them, `limb_pairs` u8 products each on
    the tensor cores; eps, a_0, a_1, dlt, b_0, b_1 (once if broadcast),
    c_0, c_1 read and z_0, z_1 written once at the element size."""
    ring = 4 * 2.0 * batch * m * n * k
    nb = 1 if broadcast_b else batch
    nbytes = float(3 * batch * m * k + 3 * nb * k * n + 4 * batch * m * n) \
        * dtype.itemsize
    return limb_pairs(dtype) * ring, ring, nbytes


def secure_matmul_plain(eps, dlt, a_sh, b_sh, c_sh) -> torch.Tensor:
    """Both parties' combine in plain torch: (2, *batch, M, N)."""
    return torch.stack([
        secure_matmul_combine(eps, dlt, a_sh[0], b_sh[0], c_sh[0], 0),
        secure_matmul_combine(eps, dlt, a_sh[1], b_sh[1], c_sh[1], 1)])


def _fn(dtype: torch.dtype):
    lib = build.lib("secure_matmul")
    f = getattr(lib, _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(eps, dlt, a_sh, b_sh, c_sh) -> torch.Tensor:
    """Run the kernel on CUDA tensors: eps (batch, M, K), dlt (batch, K,
    N), a_sh (2, batch, M, K), b_sh (2, batch, K, N), c_sh (2, batch, M,
    N). Returns z (2, batch, M, N)."""
    ts = (eps, dlt, a_sh, b_sh, c_sh)
    if not all(t.is_cuda and t.device == eps.device for t in ts):
        raise ValueError("secure_matmul kernel: operands must share one "
                         "CUDA device")
    if eps.dtype not in _FN or any(t.dtype != eps.dtype for t in ts):
        raise TypeError("secure_matmul kernel takes int32 or int64 operands "
                        "of one dtype")
    batch, m, k = eps.shape
    n = dlt.shape[-1]
    if (dlt.shape != (batch, k, n) or a_sh.shape != (2, batch, m, k)
            or b_sh.shape != (2, batch, k, n)
            or c_sh.shape != (2, batch, m, n)):
        raise ValueError("secure_matmul kernel: bad shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    ops = [batched_operand(t) for t in
           (eps, dlt, a_sh[0], a_sh[1], b_sh[0], b_sh[1], c_sh[0], c_sh[1])]
    z = torch.empty((2, batch, m, n), dtype=eps.dtype, device=eps.device)
    if z.numel() == 0:
        return z
    strides = (ctypes.c_longlong * 8)(*(s for _, s in ops))
    err = _fn(eps.dtype)(*(t.data_ptr() for t, _ in ops),
                         z[0].data_ptr(), z[1].data_ptr(),
                         ctypes.addressof(strides), batch, m, n, k,
                         torch.cuda.current_stream(eps.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"secure_matmul kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return z


@torch.library.custom_op("repro_torch::secure_matmul", mutates_args=())
def secure_matmul_op(eps: torch.Tensor, dlt: torch.Tensor,
                     a_sh: torch.Tensor, b_sh: torch.Tensor,
                     c_sh: torch.Tensor) -> torch.Tensor:
    """eps (*batch, M, K), dlt (*batch, K, N), a/b/c shares with a
    leading party axis of 2 and the same batch -> z (2, *batch, M, N)."""
    batch = tuple(eps.shape[:-2])
    m, k, n = eps.shape[-2], eps.shape[-1], dlt.shape[-1]
    if eps.device.type == "cpu":
        _stats["ref"] += 1
        return secure_matmul_plain(eps, dlt, a_sh, b_sh, c_sh)
    z = launch(eps.reshape(-1, m, k), dlt.reshape(-1, k, n),
               a_sh.reshape(2, -1, m, k), b_sh.reshape(2, -1, k, n),
               c_sh.reshape(2, -1, m, n))
    return z.reshape((2,) + batch + (m, n))


@secure_matmul_op.register_fake
def _(eps, dlt, a_sh, b_sh, c_sh):
    return c_sh.new_empty(tuple(c_sh.shape))


def _vmap_rule(info, in_dims, eps, dlt, a_sh, b_sh, c_sh):
    w = info.batch_size

    def at(t, d, pos):
        if d is not None:
            return t.movedim(d, pos)
        t = t.unsqueeze(pos)
        shape = list(t.shape)
        shape[pos] = w
        return t.expand(shape)

    d_eps, d_dlt, d_a, d_b, d_c = in_dims
    z = secure_matmul_op(at(eps, d_eps, 0), at(dlt, d_dlt, 0),
                         at(a_sh, d_a, 1), at(b_sh, d_b, 1),
                         at(c_sh, d_c, 1))
    return z, 1


secure_matmul_op.register_vmap(_vmap_rule)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
