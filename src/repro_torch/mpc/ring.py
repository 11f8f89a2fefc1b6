"""Fixed-point ring specifications for the MPC substrate.

Values x in R are encoded as round(x * 2**frac_bits) in Z_{2**bits}, stored
in two's-complement signed integers: torch's integer +/-/* wrap modulo
2**bits on both the CPU and the GPU, so they implement ring arithmetic
directly (products through the kernels accumulate in unsigned types for
the same reason; kernels/csrc/ring_limbs.cuh).

Two presets:
  RING64  int64, 16 fractional bits — CrypTen's ring.
  RING32  int32, 12 fractional bits — the narrow ring. Products of values
          |x·y| < 2**6 truncate locally with wrap probability < 2**-2 per
          element, so RING32 uses dealer-assisted truncation
          (SecureML-style) which is exact up to ±1 LSB. See ops.trunc.

Encoding follows the JAX reference bit for bit: float64 for RING64,
float32 for RING32, multiplied by an exact power of two and rounded
half-to-even. Public Python scalars encode on the host to a Python int
(no device copy, no synchronisation), tensors encode where they live.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.mpc import prng


@dataclasses.dataclass(frozen=True)
class RingSpec:
    name: str
    dtype: torch.dtype
    bits: int
    frac_bits: int

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def elem_bytes(self) -> int:
        return self.bits // 8

    @property
    def ftype(self) -> torch.dtype:
        return torch.float64 if self.bits == 64 else torch.float32

    def encode(self, x):
        """float -> ring element at the canonical scale."""
        return self.encode_at(x, self.frac_bits)

    def encode_at(self, x, fb: int):
        """float -> ring element carrying `fb` fractional bits (the
        scale-carrying shares of mpc/scale.py; fb may exceed frac_bits
        or be negative). A Python scalar encodes to a Python int."""
        if isinstance(x, (int, float)):
            ft = np.float64 if self.bits == 64 else np.float32
            enc = np.round(ft(x) * ft(2.0) ** fb)
            return int(enc.astype(np.int64 if self.bits == 64 else np.int32))
        return torch.round(x.to(self.ftype) * 2.0 ** fb).to(self.dtype)

    def decode(self, r: torch.Tensor) -> torch.Tensor:
        """ring element -> float (canonical scale)."""
        return self.decode_at(r, self.frac_bits)

    def decode_at(self, r: torch.Tensor, fb: int) -> torch.Tensor:
        """ring element carrying `fb` fractional bits -> float."""
        return r.to(self.ftype) / 2.0 ** fb

    def rand(self, key: torch.Tensor, shape) -> torch.Tensor:
        """Uniform random ring element (a fresh additive mask)."""
        if self.bits == 64:
            lo = prng.randint_u32(key, shape)
            hi = prng.randint_u32(prng.fold_in(key, 1), shape)
            return (hi << 32) | lo
        return prng.bits(key, shape).to(torch.int32)


RING64 = RingSpec("ring64", torch.int64, 64, 16)
RING32 = RingSpec("ring32", torch.int32, 32, 12)


def x64_scope():
    """No-op: torch keeps int64 and float64 without a global mode. Kept
    so callers written against the JAX package read the same."""
    return contextlib.nullcontext()
