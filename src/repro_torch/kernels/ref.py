"""Plain torch versions of the kernels — the oracles beside them.

Ring kernels (bitwise): `secure_matmul_combine` mirrors
repro/kernels/ref.py:87-98 (one party's Beaver combine). `ring_matmul` is
the wrapping integer product both kernels are built on. On the CPU it is
torch's own integer matmul; CUDA has none, so on the card it sums
K-chunked outer products elementwise. Both are exact ring arithmetic:
integer multiply and add wrap mod 2**bits.

Float kernels (allclose): `flash_attn`, `entropy_head` and
`mlp_softmax_attn` mirror repro/kernels/ref.py:8-43 in float32, with the
materialized (S x S) scores. They take the kernels' grouped layout —
q (BH, Sq, Dh) against k/v (BH / group, Skv, Dh) — and return q's dtype
(`entropy_head`: float32), as the kernels do.
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


def _kv_for(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """k or v (BH / group, S, Dh) repeated to q's BH rows, in float32."""
    return t.float().repeat_interleave(q.shape[0] // t.shape[0], dim=0)


def flash_attn(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Exact softmax attention; `causal` needs Sq == Skv (key j <= query i)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention needs Sq == Skv, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    s = q.float() @ _kv_for(q, k).transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return (torch.softmax(s, dim=-1) @ _kv_for(q, v)).to(q.dtype)


def entropy_head(logits) -> torch.Tensor:
    """H = log Z - E_p[x] per row: (R, V) -> (R,) float32."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    z = e.sum(-1)
    return m[:, 0] + torch.log(z) - (x * e).sum(-1) / z


def mlp_softmax_attn(q, k, v, w1, b1, w2, b2) -> torch.Tensor:
    """MLP-emulated attention, materialized: probs = relu(S @ w1 + b1)
    @ w2 + b2 over the scores S, out = probs @ v."""
    s = q.float() @ _kv_for(q, k).transpose(-1, -2) * q.shape[-1] ** -0.5
    probs = torch.relu(s @ w1.float() + b1.float()) @ w2.float() + b2.float()
    return (probs @ _kv_for(q, v)).to(q.dtype)
