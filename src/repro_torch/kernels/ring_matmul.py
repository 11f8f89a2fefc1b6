"""`ring_matmul`: batched wrapping integer GEMM, C[b] = A[b] @ B[b], on
int32 (RING32) and int64 (RING64) — the CUDA kernel in
csrc/ring_matmul.cu behind a torch custom op.

It is not a port of a Pallas kernel: it does the integer products the
TPU build left to XLA (`jnp.matmul(..., preferred_element_type=int32 |
int64)` — the dealer's triple, the batched attention products, every
RING64 combine), which torch cannot do on CUDA. The kernel runs them on
the int8 tensor cores: each element splits into its L bytes (limbs, L =
4 or 8), and C mod 2**(8 L) = sum_s 2**(8 s) D_s over the diagonals D_s
= sum_{i + j = s} A_i @ B_j of u8 products, `limb_pairs` of them, each
summed exactly in s32 for at most `K_CHUNK` elements of K before it is
folded into C. Bound on the card: `work` (see the source's note).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.ring_matmul`; a meta tensor (the
ledger probe, engine/trace.py) takes the fake impl. Under
`torch.func.vmap` the vmap rule folds the vmapped dim into the kernel's
batch, so a wave of lanes is ONE launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ring_matmul as ring_matmul_plain

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

_FN = {torch.int32: "ring_matmul_i32", torch.int64: "ring_matmul_i64"}
# elements of K a diagonal sums in s32 before the kernel folds it into C
# (K_CHUNK_I32 / K_CHUNK_I64 in the source): (s + 1) * 255**2 * K_CHUNK
# < 2**31 for every diagonal s < L
K_CHUNK = {torch.int32: 8192, torch.int64: 4096}


def limb_pairs(dtype: torch.dtype) -> int:
    """The u8 limb products the ring needs: pairs (i, j), i + j < L."""
    return dtype.itemsize * (dtype.itemsize + 1) // 2


def work(batch: int, m: int, k: int, n: int, dtype: torch.dtype,
         broadcast_b: bool = False) -> tuple[float, float, float]:
    """(u8 limb operations, ring operations, bytes) of one call: the limb
    products at 2 m n k each, the ring product's 2 m n k multiply-adds
    (what the CUDA cores would do), and A, B (once if broadcast) and C at
    the element size, each read or written once."""
    e = dtype.itemsize
    ring = 2.0 * batch * m * n * k
    nbytes = float(batch * m * k + (1 if broadcast_b else batch) * k * n
                   + batch * m * n) * e
    return limb_pairs(dtype) * ring, ring, nbytes


def _fn(dtype: torch.dtype):
    lib = build.lib("ring_matmul")
    f = getattr(lib, _FN[dtype])
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def batched_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (batch, rows, cols) tensor as (tensor with contiguous row-major
    inner matrices, batch stride in elements). A batch broadcast by
    `expand` keeps stride 0, so a weight is read once, not copied."""
    if t.shape[0] > 1 and t.stride(0) == 0:
        return t[0].contiguous(), 0
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        t = t.contiguous()
    return t, (t.stride(0) if t.shape[0] > 1 else 0)


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors a (batch, M, K), b (batch, K, N)."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("ring_matmul kernel: operands must share one CUDA "
                         "device")
    if a.dtype != b.dtype or a.dtype not in _FN:
        raise TypeError(f"ring_matmul kernel takes int32 or int64, got "
                        f"{a.dtype} and {b.dtype}")
    batch, m, k = a.shape
    n = b.shape[-1]
    if b.shape != (batch, k, n):
        raise ValueError(f"ring_matmul kernel: bad shapes {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    a, sa = batched_operand(a)
    b, sb = batched_operand(b)
    c = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    err = _fn(a.dtype)(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n,
                       k, sa, sb, torch.cuda.current_stream(a.device)
                       .cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_matmul kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return c


@torch.library.custom_op("repro_torch::ring_matmul", mutates_args=())
def ring_matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (*batch, M, K) @ b (*batch, K, N), same batch shape."""
    batch = tuple(a.shape[:-2])
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if a.device.type == "cpu":
        _stats["ref"] += 1
        return ring_matmul_plain(a, b)
    c = launch(a.reshape(-1, m, k), b.reshape(-1, k, n))
    return c.reshape(batch + (m, n))


@ring_matmul_op.register_fake
def _(a, b):
    return a.new_empty(tuple(a.shape[:-1]) + (b.shape[-1],))


def _vmap_rule(info, in_dims, a, b):
    w = info.batch_size

    def lead(t, d):
        return t.movedim(d, 0) if d is not None \
            else t.unsqueeze(0).expand((w,) + tuple(t.shape))

    return ring_matmul_op(lead(a, in_dims[0]), lead(b, in_dims[1])), 0


ring_matmul_op.register_vmap(_vmap_rule)


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping a @ b with torch.matmul's batch broadcasting (both
    operands at least 2-D)."""
    batch = torch.broadcast_shapes(tuple(a.shape[:-2]), tuple(b.shape[:-2]))
    return ring_matmul_op(a.expand(tuple(batch) + tuple(a.shape[-2:])),
                          b.expand(tuple(batch) + tuple(b.shape[-2:])))


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
