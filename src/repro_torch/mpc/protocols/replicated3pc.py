"""Replicated 2-out-of-3 sharing — honest-majority 3PC, NO dealer.

Share layout: three uniform additive components on the leading axis,
`sh[0] + sh[1] + sh[2] = value` (mod 2**bits); party i holds the PAIR
(sh[i], sh[i+1 mod 3]) — the ABY3/Araki-et-al. replicated sharing. Any
single party sees two uniform components and learns nothing; any two
parties can reconstruct.

Multiplication is dealer-free: party i computes the local cross-terms
its pair covers,

    z_i = x_i*y_i + x_i*y_{i+1} + x_{i+1}*y_i + alpha_i,

where (alpha_0, alpha_1, alpha_2) is a ZERO sharing from the correlated
PRNG (party i and i+1 share seed k_{i+1}; alpha_i = F_{k_i} - F_{k_{i+1}}
sums to 0 and costs no interaction). The z_i already form a valid
additive 3-sharing of x*y; ONE resharing flight (party i sends z_i to
party i-1) restores replication: 1 round, 3 messages of the OUTPUT's
elements — the wire cost scales with the output, not the inputs.

The cross-terms run as TWO products, `x_i*(y_i + y_{i+1}) + x_{i+1}*y_i`
— the same ring element as the JAX package's three, so bitwise equal —
and for matmuls both products are `kernels.ops.ring_matmul` launches
(torch has no CUDA int32/int64 matmul).

Truncation is probabilistic and local (zero rounds, zero offline
bytes, any shift): regroup the three components as the 2-of-2 sharing
(sh[0]+sh[1], sh[2]), apply the SecureML local-shift trick to that pair
(correct to ±1 LSB w.p. 1 - |v|/2**(bits-1)), and re-randomize the
result back into three components with the correlated PRNG. The
re-replication message rides the next resharing flight — zero extra
rounds, but its bytes ARE priced: `trunc` emits a 0-round
`trunc_reshare` bw record of one output component, folded into the
enclosing fused flight by the batcher and mirrored by
`costs.trunc_cost(protocol="3pc")`.

There are NO offline records in this backend — `Ledger.offline_nbytes`
of any pure-3PC execution is exactly 0, and the serve/ dealer pool
places no order for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.mpc import comm, prng
from repro_torch.mpc.ring import RingSpec
from repro_torch.mpc.protocols.base import BackendDefaults, numel


class Replicated3PC(BackendDefaults):
    name = "3pc"
    n_parties = 3
    n_wire_parties = 3

    # -- sharing --------------------------------------------------------
    def share_encoded(self, key: torch.Tensor, enc: torch.Tensor,
                      ring: RingSpec) -> torch.Tensor:
        r0 = ring.rand(key, enc.shape)
        r1 = ring.rand(prng.fold_in(key, 101), enc.shape)
        return torch.stack([r0, r1, enc - r0 - r1])

    def from_public(self, enc: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(enc)
        return torch.stack([enc, z, z])

    def open_bytes(self, ring: RingSpec, n: int) -> int:
        # party i lacks component i+2; one neighbour sends it: 3 messages
        return 3 * ring.elem_bytes * n

    def open_msgs(self, sh: torch.Tensor):
        # party i holds pair (i, i+1) and lacks component i+2, which its
        # neighbour i+1 (holder of (i+1, i+2)) sends
        return [((i + 1) % 3, i, sh[(i + 2) % 3]) for i in range(3)]

    # -- correlated-PRNG zero sharing -----------------------------------
    def _zero_share(self, key: torch.Tensor, shape,
                    ring: RingSpec) -> torch.Tensor:
        """(3, *shape) components summing to 0: alpha_i = r_i - r_{i+1}
        where r_i comes from the seed parties i and i-1 share."""
        r = torch.stack([ring.rand(prng.fold_in(key, 300 + i), shape)
                         for i in range(3)])
        return r - torch.roll(r, -1, 0)

    # -- truncation -----------------------------------------------------
    def trunc(self, x, key: torch.Tensor | None, *,
              shift: int | None = None):
        """Probabilistic local truncation via the 2-of-2 regrouping —
        both rings, zero rounds, zero dealer bytes, any shift; a
        |v|/2**(bits-1) per-element wrap probability.

        The regrouped result is re-randomized back into three components
        and re-replicated: party 1's fresh component reaches party 0 on
        the next resharing flight, recorded here as a 0-round bw record
        the flight batcher folds into the enclosing fused flight.
        Keyless boundary truncs skip re-randomization and the message."""
        ring = x.ring
        shift = ring.frac_bits if shift is None else shift
        out_fb = x.fb - shift
        # torch's >> on signed ints is arithmetic, as the ring needs
        hi = (x.sh[0] + x.sh[1]) >> shift
        lo = -((-x.sh[2]) >> shift)
        if key is None:
            return x.with_scale(torch.stack([hi, torch.zeros_like(hi), lo]),
                                out_fb)
        r = ring.rand(key, hi.shape)
        n = numel(x.shape)
        comm.record("trunc_reshare", rounds=0, nbytes=ring.elem_bytes * n,
                    numel=n, tag="bw", payload=[(1, 0, r)])
        return x.with_scale(torch.stack([hi - r, r, lo]), out_fb)

    # -- multiplication -------------------------------------------------
    def _cross_terms(self, xs: torch.Tensor, ys: torch.Tensor,
                     key: torch.Tensor, ring: RingSpec,
                     mm: bool) -> torch.Tensor:
        x_n = torch.roll(xs, -1, 0)
        y_n = torch.roll(ys, -1, 0)
        if mm:
            z = kops.ring_matmul(xs, ys + y_n) + kops.ring_matmul(x_n, ys)
        else:
            z = xs * (ys + y_n) + x_n * ys
        return z + self._zero_share(key, z.shape[1:], ring)

    def mul(self, x, y, key: torch.Tensor):
        """Elementwise multiply: local cross-terms + one resharing
        flight (no triple, no opening). Raw product — scale bookkeeping
        lives in `mpc/ops.py`."""
        ring = x.ring
        shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
        xb = x.sh.expand((3,) + shape)
        yb = y.sh.expand((3,) + shape)
        z = self._cross_terms(xb, yb, prng.fold_in(key, 1), ring, mm=False)
        n = numel(shape)
        comm.record("reshare_mul", rounds=1, nbytes=3 * ring.elem_bytes * n,
                    numel=n, flops=6 * n, tag="bw",
                    payload=[(i, (i - 1) % 3, z[i]) for i in range(3)])
        return x.with_sh(z)

    def matmul(self, x, y, key: torch.Tensor, *,
               fused_combine: bool = False):
        """Batched matmul: the local cross-term products per party + one
        resharing flight of the OUTPUT (bytes ~ batch*m*n, vs 2PC's
        |x|+|y|). `fused_combine` is the 2PC Beaver-combine knob and is
        ignored: no product here goes through `secure_matmul`."""
        ring = x.ring
        z = self._cross_terms(x.sh, y.sh, prng.fold_in(key, 1), ring,
                              mm=True)
        m, k = x.shape[-2], x.shape[-1]
        n_out = y.shape[-1]
        batch = numel(z.shape[1:-2])
        n = batch * m * n_out
        comm.record("reshare_matmul", rounds=1,
                    nbytes=3 * ring.elem_bytes * n, numel=n,
                    flops=6 * batch * m * k * n_out, tag="bw",
                    payload=[(i, (i - 1) % 3, z[i]) for i in range(3)])
        return x.with_sh(z)
