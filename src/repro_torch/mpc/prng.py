"""Threefry-2x32 counter PRNG, bitwise equal to `jax.random`.

Every share mask, Beaver triple and truncation pair of the MPC path is
drawn from a key, so reproducing JAX's key stream bit for bit is what
makes the port's shares, scores and survivors comparable bitwise with
the JAX package — and the card's run comparable bitwise with the CPU's.

Semantics reproduced (threefry with `jax_threefry_partitionable=True`):

  key(seed)        (seed >> 32, seed & 0xFFFFFFFF)
  fold_in(k, d)    threefry2x32(k, (0, d))
  split(k, n)[i]   threefry2x32(k, (0, i))       == fold_in(k, i)
  bits(k, shape)   x0 ^ x1 of threefry2x32(k, (hi, lo)) over the flat
                   row-major iota of `shape`, split into 32-bit halves
  randint_u32(k)   randint(k, shape, 0, 2**32, uint32): JAX draws two
                   bit arrays from split(k, 2) and folds them modulo the
                   span; at the full uint32 range the span wraps to 0
                   and XLA's `x % 0 == x` leaves the SECOND key's bits

Keys are `(..., 2)` int64 tensors, so a wave of keys batches under
`torch.func.vmap` like any other tensor. The 32-bit words live in int64
tensors masked to 0xFFFFFFFF: torch's uint32 op coverage is thin, and
int64 holds every intermediate of the hash exactly. On the meta device
(the ledger probe, engine/trace.py) only shapes exist, so the hash is
skipped and an empty tensor of the right shape returned.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on masked int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` as its raw (2,) key data."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def _halves(k: torch.Tensor, ndim: int):
    """Key words shaped to broadcast over `ndim` trailing counter dims."""
    kb = tuple(k.shape[:-1])
    k0 = k[..., 0].reshape(kb + (1,) * ndim)
    k1 = k[..., 1].reshape(kb + (1,) * ndim)
    return k0, k1


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: (..., 2) -> (..., 2)."""
    if k.is_meta:
        return torch.empty_like(k)
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & MASK)
    return torch.stack([x0, x1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) -> (..., num, 2)."""
    if k.is_meta:
        return k.new_empty(tuple(k.shape[:-1]) + (num, 2))
    k0, k1 = _halves(k, 1)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([x0, x1], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(k, shape, uint32)` as masked int64:
    (..., 2) -> (..., *shape)."""
    shape = tuple(int(d) for d in shape)
    if k.is_meta:
        return k.new_empty(tuple(k.shape[:-1]) + shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    k0, k1 = _halves(k, len(shape))
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return x0 ^ x1


def randint_u32(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.randint(k, shape, 0, 2**32, uint32)` as masked int64."""
    return bits(split(k, 2)[..., 1, :], shape)
