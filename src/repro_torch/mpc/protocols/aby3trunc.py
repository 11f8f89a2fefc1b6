"""ABY3 exact truncation (trunc2) over replicated 2-of-3 sharing.

Identical to `replicated3pc` everywhere except `trunc`: the
probabilistic regrouped local shift (wrap probability |v|/2**(bits-1)
per element) is replaced by ABY3's two-phase EXACT subprotocol:

  phase 1  the parties jointly generate replicated sharings of a random
           pair (r, r >> shift), r drawn from the safe range
           [0, 2**(bits-2)) — one resharing round of 2 tensors;
  phase 2  open the masked value m = x + r (3 messages), shift the now
           PUBLIC m exactly, and output <m >> shift> - <r >> shift>.

Phase 2 depends on phase 1's messages, so the two phases never share a
flight: `trunc` emits ONE `trunc2` record of rounds=2 — a multi-round
record is what the flight batcher treats as a barrier (flush, then
record eagerly). Its payload is 4-tuples with sub-rounds 0 and 1.

Error is <= 1 ulp always — zero regrouping wraps on both rings. Keyless
boundary truncs fall back to the parent's probabilistic regroup; the
engine threads keys through every force site, so the executed forward
never takes that path. Still semi-honest and dealer free: zero offline
bytes, like its parent.
"""
from __future__ import annotations

import torch

from repro_torch.mpc import comm, prng
from repro_torch.mpc.protocols.base import numel
from repro_torch.mpc.protocols.replicated3pc import Replicated3PC


class ABY3Trunc(Replicated3PC):
    name = "aby3trunc"
    # trunc2 is exact at any shift/exponent, so the scale lattice may
    # defer up to the ring-wide 3f headroom cap
    exact_trunc = True

    def trunc(self, x, key: torch.Tensor | None, *,
              shift: int | None = None):
        """Two-phase exact truncation (see module docstring). One
        `trunc2` record: rounds=2, bytes = 2 phases x 3 messages of one
        tensor each."""
        ring = x.ring
        shift = ring.frac_bits if shift is None else shift
        if key is None:
            # boundary-only fallback: probabilistic regroup
            return super().trunc(x, key, shift=shift)
        out_fb = x.fb - shift
        n = numel(x.shape)
        kr, k1, k2 = prng.split(key, 3).unbind(-2)
        # r from the "safe" range [0, 2**(bits-2)): a LOGICAL shift of the
        # unsigned view; torch's >> on signed ints is arithmetic, so mask
        # off the sign-extended bits
        r = (ring.rand(kr, x.shape) >> 2) & ((1 << (ring.bits - 2)) - 1)
        r_t = r >> shift
        rsh = self.share_encoded(k1, r, ring)
        rtsh = self.share_encoded(k2, r_t, ring)
        masked = x.sh + rsh
        # sub-round 0: the pair-generation resharing (one component per
        # party); sub-round 1: the dependent masked open
        comm.record("trunc2", rounds=2, nbytes=6 * ring.elem_bytes * n,
                    numel=n, tag="bw",
                    payload=[(i, (i - 1) % 3, rsh[i], 0) for i in range(3)]
                    + [((i + 1) % 3, i, masked[(i + 2) % 3], 1)
                       for i in range(3)])
        m = masked[0] + masked[1] + masked[2]        # open x + r
        m_t = m >> shift                              # public exact shift
        out = torch.stack([m_t - rtsh[0], -rtsh[1], -rtsh[2]])
        return x.with_scale(out, out_fb)
