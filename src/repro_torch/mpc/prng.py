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

import numpy as np

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


# ---------------------------------------------------------------------------
# bounded integers and floats: jax.random's randint (int32), uniform and
# normal (float32), with its split order
# ---------------------------------------------------------------------------

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval)` at jax's default
    int32, as int64 values: two bit arrays from `split(k)`, folded into
    the span with jax's multiplier-and-mod scheme in uint32 arithmetic
    (wrapping products and sums), bitwise equal to jax."""
    if not INT32_MIN <= minval <= INT32_MAX \
            or not INT32_MIN <= maxval <= INT32_MAX:
        raise ValueError(f"randint: bounds [{minval}, {maxval}) outside "
                         "int32")
    k1, k2 = split(k, 2).unbind(-2)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = (((hi % span) * mult & MASK) + lo % span) & MASK
    v = (minval + off % span) & MASK
    return torch.where(v > INT32_MAX, v - 2 ** 32, v)


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`: the top 23
    bits as a float32 mantissa in [1, 2), minus 1, scaled into the range
    by one fused multiply-add (as XLA contracts f * (hi - lo) + lo; here
    in float64, the product exact, then rounded once to float32) and
    clamped below at minval; bitwise equal to jax."""
    f32, f64 = torch.float32, torch.float64
    m = (bits(k, shape) >> 9) | 0x3F800000
    f = m.to(torch.int32).view(f32) - 1.0
    lo = torch.tensor(minval, dtype=f32, device=f.device)
    hi = torch.tensor(maxval, dtype=f32, device=f.device)
    v = (f.to(f64) * (hi - lo).to(f64) + lo.to(f64)).to(f32)
    return torch.maximum(lo, v)


# Giles' single-precision erfinv polynomial (w < 5, w >= 5), in the form
# jax lowers `lax.erf_inv` to (chlo.erf_inv)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv, op for op as jax computes it on the CPU:
    w = -log1p(-x * x); w - 2.5 (w < 5) or sqrt(w) - 3; a degree-8
    Horner polynomial in w whose steps are fused multiply-adds (each one
    here in float64, exact product then one rounding, as XLA contracts
    them); times x; +-inf at |x| = 1. XLA's own log1p rounds differently
    from torch's in some last bits (tests state the ulp bound)."""
    f32, f64 = torch.float32, torch.float64
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(f64)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=f32),
                           torch.tensor(_ERFINV_GE5[i], dtype=f32))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i).to(f64) + p.to(f64) * w).to(f32)
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32: u uniform on
    (nextafter(-1, 0), 1), then sqrt(2) * erf_inv(u)."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32) * erf_inv(u)
