"""Linear algebra over secret shares — protocol-generic, scale-carrying.

Everything here works on any `sharing.Share` regardless of backend:
local linear ops transform the stacked components directly (party-axis
size is whatever the protocol dictates), while every scheme-dependent
op (multiplication, matmul, truncation) dispatches to the share's
`ProtocolBackend` (mpc/protocols/).

Fixed-point scale is a tracked property of the value (`Share.fb`, the
mpc/scale.py lattice), not an op-boundary invariant:

  add/sub/concat/stack ......... align exponents by exact local lifts
  mul_public by ±2**k .......... pure exponent fold — zero arithmetic
  mul_public general ........... encode at f, emit at fb+f, NO trunc
  mul / matmul ................. emit at the summed exponent (<= 2f),
                                 forcing inputs down only when the 2f
                                 headroom cap demands it
  force (this module) .......... THE truncation point: one
                                 backend.trunc(shift=excess) per value,
                                 memoized on the Share and pushed
                                 through layout lineage

so a product's truncation is paid once, where a scale-sensitive
consumer (comparison, nonlinear entry point, another multiply) actually
needs it — not once per op.

Cost accounting notes (all recorded into the ambient Ledger):
  add/sub/neg/sum/lifts/pow2 folds ......... local, 0 rounds
  mul / matmul, 2pc (Beaver) ............... 1 round: open(eps)+open(delta)
                                             + offline dealer bytes
  mul / matmul, 3pc, aby3trunc ............. 1 round: resharing flight,
                                             no dealer, no offline bytes
  mul / matmul, spdz2pc .................... 2 rounds: sacrifice + MAC'd
                                             Beaver open, doubled offline
  force, 2pc RING64 ........................ 0 rounds (local shift)
  force, 2pc RING32 ........................ 1 round + offline trunc pair
  force, 3pc both rings .................... local shift + re-replication
                                             bytes on the next resharing
                                             flight (0 rounds)
  force, aby3trunc both rings .............. one exact trunc2: 2 rounds
  force, spdz2pc both rings ................ 1 round + MAC'd trunc pair

Under an ambient `fusion.flight_scope` every 1-round opening/resharing
is deferred into the current fused flight instead of paying its own
round (mpc/fusion.py); the arithmetic below never changes.

All integer arithmetic relies on torch's modular two's-complement
semantics, which *is* ring arithmetic mod 2**bits. Integer `sum` would
promote int32 to int64 in torch, so sums pass the ring's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.mpc.sharing import Share
from repro_torch.mpc import prng, scale


# ---------------------------------------------------------------------------
# scale plumbing: lifts, forced truncation, alignment
# ---------------------------------------------------------------------------

def lift(x: Share, k: int) -> Share:
    """Raise the carried exponent by k: int * 2**k — exact, local, free.
    Spends headroom instead of precision (the scale.align_target cap
    guarantees the result stays within the 2f contract)."""
    if k == 0:
        return x
    return x.with_scale(x.sh * (1 << k), x.fb + k)


def force(x: Share, key: torch.Tensor | None = None, *,
          to: int | None = None) -> Share:
    """Resolve a scale-carrying share to exponent `to` (canonical f by
    default) — THE deferred-truncation consumer.

    Sub-target exponents lift (free); excess truncates ONCE via the
    backend's `trunc(shift=)`. The result is memoized on the Share (a
    value consumed by several scale-sensitive ops pays one truncation,
    not one per consumer) and pushed through layout lineage
    (`Share.derive`): forcing a broadcast/reshaped view truncates the
    pre-layout tensor at its element count and replays the free layout.
    """
    t = x.ring.frac_bits if to is None else to
    if x.fb == t:
        return x
    if x.fb < t:
        return lift(x, t - x.fb)
    cache = getattr(x, "_forced", None)
    if cache is None:
        cache = x._forced = {}
    if t in cache:
        return cache[t]
    lineage = getattr(x, "_lineage", None)
    if lineage is not None:
        base, fn = lineage
        fbase = force(base, key, to=t)
        out = fbase.with_sh(fn(fbase.sh))
    else:
        out = x.backend.trunc(x, key, shift=x.fb - t)
    cache[t] = out
    return out


def _headroom_bits(x: Share) -> int | None:
    """Ring bit width handed to the scale lattice's headroom cap — only
    when the backend's truncation is EXACT at any shift
    (`backend.exact_trunc`). Probabilistic local truncation
    (additive2pc's RING64 shift) wraps a
    share w.p. ~ encoded/2**bits per element; at a 3f exponent that is
    2**f times the validated 2f regime, so those backends keep the 2f
    cap (`scale.cap(f, None)`)."""
    return x.ring.bits if x.backend.exact_trunc else None


def _aligned(xs: list[Share], key: torch.Tensor | None = None) -> list[Share]:
    """Bring operands to a common exponent for add/sub/concat: lift the
    lower ones (exact, free); trunc down only in the above-cap case
    scale.align_target clamps (a pow2-folded mean meeting a 2f residual).

    That down-force is a REAL truncation and takes the caller's key —
    keyless it degrades to the local-shift path, whose share-wrap
    probability is unacceptable for fb > 2f on the 32-bit ring (the
    MPCEngine threads a key through every add/sub for exactly this
    case; key-free library callers only ever align same-exponent or
    lift-direction operands)."""
    f = xs[0].ring.frac_bits
    t = xs[0].fb
    for x in xs[1:]:
        t = scale.align_target(t, x.fb, f, _headroom_bits(xs[0]))
    out = []
    for i, x in enumerate(xs):
        if x.fb != t:
            kx = None if key is None else prng.fold_in(key, 50 + i)
            x = force(x, kx, to=t)
        out.append(x)
    return out


# ---------------------------------------------------------------------------
# local (round-free) ops — party-axis generic
# ---------------------------------------------------------------------------

def add(x: Share, y: Share, *, key: torch.Tensor | None = None) -> Share:
    x, y = _aligned([x, y], key)
    return x.with_sh(x.sh + y.sh)


def sub(x: Share, y: Share, *, key: torch.Tensor | None = None) -> Share:
    x, y = _aligned([x, y], key)
    return x.with_sh(x.sh - y.sh)


def neg(x: Share) -> Share:
    return x.with_sh(-x.sh)


def add_public(x: Share, v) -> Share:
    """Add a public constant, encoded at the carried exponent. Affine,
    not linear in the components — dispatches to the backend (component
    0 absorbs it)."""
    enc = x.ring.encode_at(v, x.fb)
    return x.with_sh(x.backend.add_public_encoded(x.sh, enc))


def mul_public(x: Share, v, *, key: torch.Tensor | None = None) -> Share:
    """Multiply by a public float tensor.

    Scalar powers of two fold into the carried exponent — zero
    arithmetic, zero rounding, zero wire (the attention `dh**-0.5`
    rescale and pow2 means cost literally nothing). General constants
    encode at f and emit at fb+f; no truncation here — the downstream
    scale-sensitive consumer forces once at the accumulated excess.
    """
    k = scale.pow2_exponent(v)
    if k is not None:
        sh = -x.sh if float(v) < 0 else x.sh
        return x.with_scale(sh, x.fb - k)
    _, shift, out_fb = scale.mul_public_plan(x.fb, v, x.ring.frac_bits,
                                             _headroom_bits(x))
    if shift:
        x = force(x, key, to=x.fb - shift)
    enc = x.ring.encode(v if torch.is_tensor(v) else float(v))
    return x.with_scale(x.sh * enc, out_fb)


def mul_public_int(x: Share, v: int) -> Share:
    """Multiply by a public *integer* — exact, scale-preserving."""
    return x.with_sh(x.sh * int(v))


def matmul_public(x: Share, w, *, key: torch.Tensor | None = None,
                  w_encoded: torch.Tensor | None = None) -> Share:
    """x @ w with public (already known to all parties) w; emits at
    fb+f like `mul_public` — consumers force. The integer product is a
    `ring_matmul` launch on the card."""
    px, _, _ = scale.mul_plan(x.fb, x.ring.frac_bits, x.ring.frac_bits,
                              _headroom_bits(x))
    if px:
        x = force(x, key, to=x.fb - px)
    enc = w_encoded if w_encoded is not None else x.ring.encode(
        torch.as_tensor(w, device=x.sh.device))
    z = kops.ring_matmul(x.sh, enc)
    return x.with_scale(z, x.fb + x.ring.frac_bits)


def sum_(x: Share, axis=None, keepdims=False) -> Share:
    ax = axis
    if ax is not None:
        ax = tuple(a + 1 if a >= 0 else a for a in
                   ((axis,) if isinstance(axis, int) else tuple(axis)))
    else:
        ax = tuple(range(1, x.sh.ndim))
    return x.with_sh(torch.sum(x.sh, dim=ax, keepdim=keepdims,
                               dtype=x.sh.dtype))


def mean(x: Share, axis: int, *, key: torch.Tensor | None = None) -> Share:
    """Sum then multiply by 1/n — the 1/n lands on the (smaller) summed
    tensor, and for power-of-two n it is a free exponent fold."""
    n = x.shape[axis]
    s = sum_(x, axis=axis)
    return mul_public(s, 1.0 / n, key=key)


def stack(xs: list[Share], axis: int = 0, *,
          key: torch.Tensor | None = None) -> Share:
    xs = _aligned(xs, key)
    return xs[0].with_sh(torch.stack([x.sh for x in xs], dim=axis + 1))


def concat(xs: list[Share], axis: int = 0, *,
           key: torch.Tensor | None = None) -> Share:
    xs = _aligned(xs, key)
    ax = axis + 1 if axis >= 0 else axis
    return xs[0].with_sh(torch.cat([x.sh for x in xs], dim=ax))


# ---------------------------------------------------------------------------
# scheme-dependent ops: dispatch to the share's protocol backend
# ---------------------------------------------------------------------------

def trunc(x: Share, *, key: torch.Tensor | None = None,
          shift: int | None = None) -> Share:
    """Divide by 2**shift (default: one canonical scale, frac_bits).

    2pc RING64: local arithmetic shifts (CrypTen's choice).
    2pc RING32: dealer-assisted pair — exact, one opening round.
    3pc:        probabilistic local shift, both rings — no dealer; the
                re-replication message is priced on the resharing flight.
    aby3trunc:  exact two-round trunc2, both rings, no dealer.
    spdz2pc:    MAC'd dealer pair, both rings; raises without a key.
    """
    return x.backend.trunc(x, key, shift=shift)


def _forced_operands(x: Share, y: Share, key: torch.Tensor):
    """Apply scale.mul_plan: trunc inputs only as far as the ring's
    headroom cap requires (2f; 3f on RING64 exact-trunc backends). A
    squared operand
    (x is y) forces once and reuses."""
    px, py, out_fb = scale.mul_plan(x.fb, y.fb, x.ring.frac_bits,
                                    _headroom_bits(x))
    if x is y:
        if px:
            x = y = force(x, prng.fold_in(key, 3), to=x.fb - px)
        return x, y, out_fb
    if px:
        x = force(x, prng.fold_in(key, 3), to=x.fb - px)
    if py:
        y = force(y, prng.fold_in(key, 4), to=y.fb - py)
    return x, y, out_fb


def mul(x: Share, y: Share, key: torch.Tensor) -> Share:
    """Elementwise secure multiply — one wire flight (Beaver opening for
    2pc), emitted at the summed exponent x.fb + y.fb
    (post headroom plan). No inline truncation: the consumer forces."""
    x, y, out_fb = _forced_operands(x, y, key)
    z = x.backend.mul(x, y, key)
    return z.with_scale(z.sh, out_fb)


def square(x: Share, key: torch.Tensor) -> Share:
    return mul(x, x, key)


def matmul(x: Share, y: Share, key: torch.Tensor, *,
           fused_combine: bool = False) -> Share:
    """Secure batched matmul — one wire flight, emitted at the summed
    exponent. 2pc bytes scale with the INPUTS (Beaver triple reuse);
    `fused_combine` routes the 2pc RING32 post-open combine through the
    two-party secure_matmul kernel."""
    x, y, out_fb = _forced_operands(x, y, key)
    z = x.backend.matmul(x, y, key, fused_combine=fused_combine)
    return z.with_scale(z.sh, out_fb)
