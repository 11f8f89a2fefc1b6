"""CrypTen-style nonlinear baselines over shares.

These are the *expensive* ops the paper replaces with MLPs. They are real
share-level protocols built from Beaver multiplications (exp, reciprocal,
rsqrt, log) plus the comparison functionality (max, relu). Their cost is
what makes the "Oracle" so slow; the ambient Ledger records it.

Scale discipline: every public entry point FORCES its input to the
canonical exponent first (`ops.force`) — the iterative approximations
are tuned for canonical fixed-point precision, and forcing at the
boundary keeps each protocol's internal op/cost stream identical no
matter what carried exponent the caller accumulated (mpc/scale.py).
Inside, products ride at 2f and the next iteration's multiply forces
them back. Outputs are returned at their natural (usually 2f) exponent;
the caller's consumer forces once more if it cares.

Every key derives at the same site and in the same order as in the JAX
package (`prng.fold_in` / `prng.split`), so shares and ledgers are its
bit for bit. The arithmetic is elementwise ring arithmetic and threefry
draws, plain torch ops on either device.

Approximation choices follow CrypTen (Knott et al. 2021):
  exp(x)        limit approximation (1 + x/2**t)**(2**t), t=8 squarings
  reciprocal(x) Newton-Raphson, init 3*exp(0.5-x)+0.003, 10 iterations
  rsqrt/sqrt    Newton-Raphson on y -> y(3 - x y^2)/2, 10 iterations
  log(x)        Householder iterations (CrypTen uses 8)
  softmax       x - max(x); exp; sum; reciprocal; mul
  gelu          MPCFormer's quad: x(0.125x^2 + 0.25x + 0.5)
"""
from __future__ import annotations

import torch

from repro_torch.mpc.sharing import Share, from_public
from repro_torch.mpc import compare, ops, prng

EXP_ITERS = 8
RECIP_ITERS = 10
RSQRT_ITERS = 10
LOG_ITERS = 8


def _split(key: torch.Tensor, n: int):
    return prng.split(key, n).unbind(-2)


def _public(v, like: Share):
    """A public operand where `like`'s shares live: scalars stay Python
    numbers, arrays become tensors of their own dtype."""
    if isinstance(v, (int, float)):
        return v
    return torch.as_tensor(v, device=like.sh.device)


def exp(x: Share, key: torch.Tensor) -> Share:
    """(1 + x/2**t)**(2**t): t sequential squarings = t rounds."""
    x = ops.force(x, prng.fold_in(key, 89))
    # x/2**t is a pure exponent fold; the first squaring forces it back
    y = ops.add_public(ops.mul_public(x, 1.0 / (1 << EXP_ITERS),
                                      key=prng.fold_in(key, 99)), 1.0)
    for i in range(EXP_ITERS):
        y = ops.square(y, prng.fold_in(key, i))
    return y


def reciprocal(x: Share, key: torch.Tensor) -> Share:
    """NR iterations y <- y(2 - x y); init 3 exp(0.5 - x) + 0.003."""
    x = ops.force(x, prng.fold_in(key, 89))
    k0, key = _split(key, 2)
    init = ops.add_public(
        ops.mul_public(exp(ops.add_public(ops.neg(x), 0.5), k0), 3.0,
                       key=prng.fold_in(key, 98)),
        0.003)
    y = init
    for i in range(RECIP_ITERS):
        ki = prng.fold_in(key, i)
        xy = ops.mul(x, y, ki)
        y = ops.mul(y, ops.add_public(ops.neg(xy), 2.0),
                    prng.fold_in(ki, 1))
    return y


def rsqrt(x: Share, key: torch.Tensor) -> Share:
    """NR for 1/sqrt(x): y <- y(3 - x y^2)/2, init 3*exp(-(x/2+0.2))+0.2."""
    x = ops.force(x, prng.fold_in(key, 89))
    k0, key = _split(key, 2)
    init = ops.add_public(
        ops.mul_public(
            exp(ops.add_public(ops.mul_public(ops.neg(x), 0.5,
                                              key=prng.fold_in(key, 97)),
                               -0.2), k0),
            3.0, key=prng.fold_in(key, 96)),
        0.2)
    y = init
    for i in range(RSQRT_ITERS):
        ki = prng.fold_in(key, i)
        y2 = ops.square(y, ki)
        xy2 = ops.mul(x, y2, prng.fold_in(ki, 1))
        y = ops.mul_public(
            ops.mul(y, ops.add_public(ops.neg(xy2), 3.0),
                    prng.fold_in(ki, 2)),
            0.5, key=prng.fold_in(ki, 3))
    return y


def log(x: Share, key: torch.Tensor) -> Share:
    """Householder iterations: y <- y - 1 + x*exp(-y) (order-1 form)."""
    x = ops.force(x, prng.fold_in(key, 89))
    y = ops.add_public(ops.mul_public(x, 1.0 / 120.0,
                                      key=prng.fold_in(key, 95)), 2.0)
    # crude affine init y0 ~ x/120 + 2 (CrypTen uses x/120 - 20exp(-2x-1)+3)
    for i in range(LOG_ITERS):
        ki = prng.fold_in(key, i)
        e = exp(ops.neg(y), ki)
        xe = ops.mul(x, e, prng.fold_in(ki, 1))
        y = ops.add_public(ops.add(y, xe), -1.0)
    return y


def softmax(x: Share, key: torch.Tensor, axis: int = -1,
            stabilize: bool = True) -> Share:
    """CrypTen softmax: subtract max (comparison tree), exp, normalize."""
    kmax, kexp, krec, kmul, key = _split(key, 5)
    x = ops.force(x, prng.fold_in(key, 89))
    if stabilize:
        mx = compare.max_(x, axis=axis, key=kmax)
        x = ops.sub(x, mx.with_sh(mx.sh.expand(x.sh.shape)))
    e = exp(x, kexp)
    s = ops.sum_(e, axis=axis, keepdims=True)
    r = reciprocal(s, krec)
    return ops.mul(e, r.with_sh(r.sh.expand(e.sh.shape)), kmul)


def layernorm(x: Share, gamma, beta, key: torch.Tensor,
              eps: float = 1e-5) -> Share:
    """LayerNorm with NR-rsqrt for the variance reciprocal sqrt. `gamma`
    and `beta` are public float tensors (or scalars)."""
    kvar, krs, kmul, kaff = _split(key, 4)
    mu = ops.mean(x, axis=-1, key=prng.fold_in(key, 94))
    xc = ops.sub(x, mu.with_sh(mu.sh[..., None].expand(x.sh.shape)))
    var = ops.mean(ops.square(xc, kvar), axis=-1,
                   key=prng.fold_in(key, 93))
    inv = rsqrt(ops.add_public(var, eps), krs)
    xn = ops.mul(xc, inv.with_sh(inv.sh[..., None].expand(xc.sh.shape)),
                 kmul)
    out = ops.mul_public(xn, _public(gamma, x), key=kaff)
    b = _public(beta, x)
    if not torch.is_tensor(b):        # a scalar encodes at the ring's type
        b = torch.tensor(b, dtype=x.ring.ftype, device=x.sh.device)
    return ops.add(out, from_public(b.expand(out.shape), out.ring,
                                    out.proto))


def entropy_from_logits(logits: Share, key: torch.Tensor) -> Share:
    """H = -sum p log p over the class axis — the Oracle's scoring op."""
    ksm, klog, kmul, key = _split(key, 4)
    p = softmax(logits, ksm, axis=-1)
    lp = log(ops.add_public(p, 1e-6), klog)
    plp = ops.mul(p, lp, kmul)
    return ops.neg(ops.sum_(plp, axis=-1))


def gelu(x: Share, key: torch.Tensor) -> Share:
    """Quad approximation (MPCFormer uses this for the *baseline* models)."""
    k1, k2 = _split(key, 2)
    x = ops.force(x, prng.fold_in(key, 89))
    x2 = ops.square(x, k1)
    # 0.125 x^2 + 0.25 x + 0.5  (times x) — MPCFormer's "2Quad" GeLU
    inner = ops.add_public(
        ops.add(ops.mul_public(x2, 0.125, key=prng.fold_in(key, 92)),
                ops.mul_public(x, 0.25, key=prng.fold_in(key, 91))),
        0.5)
    return ops.mul(x, inner, k2)
