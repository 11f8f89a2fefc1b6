"""Secure comparison.

Protocol: modeled as an ideal functionality with the *real* protocol's
communication cost, exactly as stated by the paper (§4.1): one pairwise
comparison of two secret values costs 8 communication rounds and 432
bytes, and reveals only the binary outcome.

Semantics are computed from the summed components *inside the
functionality boundary* — the returned object is either a Share of the
bit (private outcome, used by ReLU and the tournament max) or a
revealed bool (public outcome, used by QuickSelect ranking, which the
paper explicitly reveals). Outputs inherit the input's protocol backend.
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


def le(x: Share, y: Share, key: torch.Tensor) -> Share:
    return lt_zero(ops.sub(x, y), key)


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


def max_(x: Share, axis: int, key: torch.Tensor) -> Share:
    """Tournament max along an axis: log2(n) comparison rounds."""
    cur = x
    i = 0
    while cur.shape[axis] > 1:
        m = cur.shape[axis]
        half = m // 2
        ax = axis + 1 if axis >= 0 else axis
        lo = cur.with_sh(cur.sh.narrow(ax, 0, half))
        hi = cur.with_sh(cur.sh.narrow(ax, half, half))
        kb, km, ka, key = prng.split(prng.fold_in(key, i), 4).unbind(-2)
        b = le(lo, hi, kb)                      # [lo < hi]
        diff = ops.sub(hi, lo)
        # keyed: the align clamp may FORCE lo down a real truncation
        # (keyless would be the local-shift path — wrap-prone on RING32)
        mx = ops.add(lo, ops.mul(b, diff, km), key=ka)  # lo + b*(hi-lo)
        if m % 2:
            tail = cur.with_sh(cur.sh.narrow(ax, 2 * half, m - 2 * half))
            mx = ops.concat([mx, tail], axis=axis)
        cur = mx
        i += 1
    return cur
