"""Secure comparison.

Protocol: modeled as an ideal functionality with the *real* protocol's
communication cost, exactly as stated by the paper (§4.1): one pairwise
comparison of two secret values costs 8 communication rounds and 432
bytes, and reveals only the binary outcome.

Semantics are computed from the summed components *inside the
functionality boundary* — the returned object is either a Share of the
bit (private outcome, used by ReLU) or a revealed bool (public outcome,
used by QuickSelect ranking, which the paper explicitly reveals).
Outputs inherit the input's protocol backend.
"""
from __future__ import annotations

import torch

from repro_torch.mpc.sharing import Share, reconstruct, share_encoded
from repro_torch.mpc import comm, ops, prng

CMP_ROUNDS = 8          # paper §4.1
CMP_BYTES = 432         # per scalar comparison


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def lt_zero(x: Share, key: torch.Tensor) -> Share:
    """Shares of the bit [x < 0], shared at EXPONENT 0 (integer 0/1).

    The sign of a two's-complement encoding is the sign of the value at
    any carried exponent, so scale-carrying inputs compare without
    forcing a truncation first; and a bit at exponent 0 multiplies into
    any share exactly (fb + 0 = fb) — ReLU becomes truncation-free."""
    n = _numel(x.shape)
    comm.record("secure_cmp", rounds=CMP_ROUNDS, nbytes=CMP_BYTES * n,
                numel=n, tag="lat")
    v = reconstruct(x)                         # functionality boundary
    bit = (v < 0).to(x.ring.dtype)
    return share_encoded(key, bit, x.ring, x.proto, fb=0)


def reveal_lt(x: Share, y: Share) -> torch.Tensor:
    """Public bit x<y — what QuickSelect consumes (outcome revealed)."""
    d = ops.sub(x, y)
    n = _numel(d.shape)
    comm.record("secure_cmp_reveal", rounds=CMP_ROUNDS, nbytes=CMP_BYTES * n,
                numel=n, tag="lat")
    return reconstruct(d) < 0


def relu(x: Share, key: torch.Tensor) -> Share:
    """ReLU(x) = x * [x >= 0]: one comparison + one secure multiply.
    The bit sits at exponent 0, so the multiply is exact and the output
    keeps x's carried exponent — no truncation anywhere in ReLU."""
    kb, km = prng.split(key, 2).unbind(-2)
    neg_bit = lt_zero(x, kb)
    pos_bit = ops.add_public(ops.neg(neg_bit), 1.0)
    return ops.mul(x, pos_bit, km)
