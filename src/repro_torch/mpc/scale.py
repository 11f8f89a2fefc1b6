"""The fixed-point scale lattice — one algebra for execution AND mirror.

A scale-carrying share encodes value v as round(v * 2**fb) where `fb`
(the carried frac-bits exponent, `Share.fb`) is static pytree aux data.
Canonical scale is the ring's `frac_bits` (f); a product of f-scale
operands sits at 2f, and instead of forcing a truncation at every op
boundary the exponent simply flows
through downstream ops:

  lift        (exact, local, free)   int * 2**k        fb += k
  pow2 fold   (exact, local, free)   reinterpretation  fb -= k  for * 2**k
  trunc       (a protocol op)        int >> shift      fb -= shift

The lattice cap is RING-PARAMETERIZED: any op that GROWS integer
magnitude (lifting an operand for alignment, multiplying two shares)
must keep the result's exponent at or below the cap so
|v1*v2| < 2**(bits-1-cap) — the same headroom contract eager truncation
maintained. The default cap is 2f; rings wide enough to hold a third
fraction (3f < bits-1, i.e. RING64's 48 < 63) legally defer one level
deeper — a 2f product multiplying an f operand emits at 3f with NO
force, erasing the residual RING64 truncations the uniform 2f cap
paid. RING32 (3*12 = 36 > 31) stays at 2f. Callers opt in by passing
the ring's bit width (`bits=`); the bare 3-argument form keeps the
uniform 2f cap. Pure reinterpretations (pow2 folds) may push fb beyond
the cap because the integers never move; the next magnitude-growing
consumer truncates by the accumulated excess in one shot.

This module is the decision procedure only — pure functions of static
exponents, shared verbatim by the executable ops (`mpc/ops.py`) and the
analytic mirror (`mpc/costs.proxy_exec_cost`), so "where does a forced
truncation fire" exists exactly once and the record-for-record mirror
tests catch any drift.
"""
from __future__ import annotations

import math


def cap(f: int, bits: int | None = None) -> int:
    """Max exponent a magnitude-growing op may produce.

    2f by default; 3f when the ring's bit width is given and a third
    fraction still leaves sign + headroom (3f < bits - 1): RING64
    (f=16, bits=64) caps at 48, RING32 (f=12, bits=32) stays at 24.

    Callers gate `bits` on the backend's truncation exactness
    (`ops._headroom_bits` / the costs.py mirror): probabilistic local
    truncation wraps w.p. ~ encoded/2**bits, which a 3f exponent
    amplifies 2**f-fold, so only exact-trunc backends (spdz2pc,
    aby3trunc) pass their ring width here — everyone else passes None
    and keeps the validated 2f regime.
    """
    if bits is not None and 3 * f < bits - 1:
        return 3 * f
    return 2 * f


def pow2_exponent(v) -> int | None:
    """k such that v == ±2**k for a python/numpy scalar, else None.

    Multiplying by ±2**k is a pure exponent adjustment (fb -= k) plus at
    most a negation — zero arithmetic on the fraction, zero rounding,
    zero truncation. Non-scalars and non-powers return None (the general
    encode-at-f path)."""
    try:
        x = float(v)
    except (TypeError, ValueError, RuntimeError):   # torch: many elements
        return None
    if x == 0.0 or math.isinf(x) or math.isnan(x):
        return None
    m, e = math.frexp(abs(x))       # |x| = m * 2**e, m in [0.5, 1)
    return e - 1 if m == 0.5 else None


def align_target(sa: int, sb: int, f: int, bits: int | None = None) -> int:
    """Common exponent for add/sub/concat operands at exponents sa, sb.

    Equal scales pass through (even above the cap: adding two
    reinterpreted tensors moves no integers). Otherwise the lower
    operand LIFTS to the higher exponent — exact and free — capped by
    `cap(f, bits)`: a lift beyond the cap would overflow the headroom
    contract, so the higher operand truncs down to the cap instead."""
    if sa == sb:
        return sa
    return min(max(sa, sb), cap(f, bits))


def mul_plan(sx: int, sy: int, f: int,
             bits: int | None = None) -> tuple[int, int, int]:
    """(shift_x, shift_y, out_exponent) for a share*share product.

    The product's exponent is sx + sy; while that exceeds the headroom
    cap, the larger operand is truncated — by exactly the excess when
    that suffices, never below canonical f. Two f-scale inputs emit at
    2f untruncated; a cap-scale input against an exponent-0 input (a
    comparison bit) multiplies for free. Under the 2f cap, 2f x f and
    2f x 2f force the carried truncation that eager mode paid
    per-product; under a ring-wide 3f cap (RING64) the 2f x f case
    emits at 3f force-free."""
    c = cap(f, bits)
    s = [sx, sy]
    shift = [0, 0]
    while s[0] + s[1] > c:
        i = 0 if s[0] >= s[1] else 1
        if s[i] <= f:
            break                   # both canonical: 2f is legal by cap
        red = s[0] + s[1] - c
        if s[0] == s[1]:
            # equal operands split the excess SYMMETRICALLY (the loop
            # pass reduces each side by half) — a squared operand
            # (x is y in ops._forced_operands) forces once and reuses,
            # which is only coherent when shift_x == shift_y
            red = -(-red // 2)
        red = min(s[i] - f, red)
        shift[i] += red
        s[i] -= red
    return shift[0], shift[1], s[0] + s[1]


def mul_public_plan(s: int, v, f: int,
                    bits: int | None = None) -> tuple[int | None, int, int]:
    """(fold_exponent, force_shift, out_exponent) for share * public v.

    Power-of-two scalars fold into the exponent (fold_exponent = k,
    force_shift = 0, out = s - k). General constants encode at f and
    multiply: if the product s + f would pass the cap, the input forces
    down by `force_shift` first — exactly to the exponent where the
    product lands on the cap (canonical under 2f; up to 2f input under
    a ring-wide 3f cap)."""
    k = pow2_exponent(v)
    if k is not None:
        return k, 0, s - k
    shift = max(0, s - (cap(f, bits) - f))   # product lands on the cap
    return None, shift, (s - shift) + f
