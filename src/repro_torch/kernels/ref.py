"""Plain torch versions of the ring kernels — the bitwise oracles.

`secure_matmul_combine` mirrors repro/kernels/ref.py:87-98 (one party's
Beaver combine). `ring_matmul` is the wrapping integer product both
kernels are built on. On the CPU it is torch's own integer matmul; CUDA
has none, so on the card it sums K-chunked outer products elementwise.
Both are exact ring arithmetic: integer multiply and add wrap mod 2**bits.
"""
from __future__ import annotations

import torch

# bound on the (..., M, chunk, N) intermediate of the card's version
_CHUNK_BYTES = 1 << 28


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping integer a @ b, broadcasting batch dims like torch.matmul."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    return matmul_by_chunks(a, b)


def matmul_by_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a sum over K-chunks of broadcast products — integer
    matmul from elementwise ops only (torch has no CUDA int matmul)."""
    k = a.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    per_k = batch.numel() * a.shape[-2] * b.shape[-1] * a.element_size()
    chunk = max(1, min(k, _CHUNK_BYTES // max(1, per_k)))
    out = None
    for k0 in range(0, k, chunk):
        part = (a[..., :, k0:k0 + chunk, None]
                * b[..., None, k0:k0 + chunk, :]).sum(-2, dtype=a.dtype)
        out = part if out is None else out + part
    return out


def secure_matmul_combine(eps, dlt, a_sh, b_sh, c_sh, party: int):
    """One party's Beaver combine: z_p = c_p + eps@b_p + a_p@dlt
    (+ party 0: eps@dlt), wrapping ring arithmetic."""
    z = c_sh + ring_matmul(eps, b_sh) + ring_matmul(a_sh, dlt)
    if party == 0:
        z = z + ring_matmul(eps, dlt)
    return z
