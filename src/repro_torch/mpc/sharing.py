"""Protocol-generic secret shares.

A `Share` stacks every party's share component on a leading axis whose
size the protocol backend decides (`mpc/protocols/`): 2 for additive
2PC (`sh[0] + sh[1] = value`), 3 for replicated 3PC and aby3trunc, 4
for spdz2pc (two value rows and two MAC rows).

The container carries the ring, the protocol name, AND the fixed-point
scale it is currently encoded at (`fb`, the carried frac-bits exponent
of mpc/scale.py) as plain static metadata next to the component tensor.
Every op that depends on the sharing scheme — `share`, `open_`,
multiplication, truncation — routes through the backend registered
under `proto`; every op that changes the scale adjusts `fb`, so "this
tensor still owes a truncation" is a tracked property of the value.

Opening is the one scale boundary that resolves for free: a revealed
ring element is public, so the receiver applies the exact division by
2**fb during decode — `reveal` never forces a truncation (see ops.force
for the consumers that must).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.mpc.ring import RingSpec, RING64
from repro_torch.mpc import comm


@dataclasses.dataclass
class Share:
    sh: torch.Tensor              # (n_parties, *shape) ring ints
    ring: RingSpec
    proto: str = "2pc"            # protocol backend name
    fb: int | None = None         # carried frac-bits exponent
                                  # (None normalizes to ring.frac_bits)

    def __post_init__(self):
        if self.fb is None:
            self.fb = self.ring.frac_bits

    # -- convenience ----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.sh.shape[1:])

    @property
    def ndim(self) -> int:
        return self.sh.ndim - 1

    @property
    def n_parties(self) -> int:
        return self.sh.shape[0]

    @property
    def excess(self) -> int:
        """Frac bits above canonical — the truncation this value owes."""
        return self.fb - self.ring.frac_bits

    @property
    def backend(self):
        from repro_torch.mpc import protocols
        return protocols.get(self.proto)

    def with_sh(self, sh: torch.Tensor) -> "Share":
        """Same ring/protocol/SCALE, new share components — THE way to
        rebuild a share from a scale-preserving transform."""
        return Share(sh, self.ring, self.proto, self.fb)

    def with_scale(self, sh: torch.Tensor, fb: int) -> "Share":
        """Rebuild at a different carried exponent (product emission,
        truncation, lifts)."""
        return Share(sh, self.ring, self.proto, fb)

    def derive(self, fn) -> "Share":
        """Scale-preserving LAYOUT transform (reshape/moveaxis/broadcast
        ...) that remembers its source: `ops.force` walks this lineage
        so a forced truncation fires once on the pre-layout tensor (at
        its smaller element count, for broadcasts) and the cheap layout
        replays on the truncated components."""
        out = self.with_sh(fn(self.sh))
        out._lineage = (self, fn)
        return out

    def __getitem__(self, idx) -> "Share":
        idx = idx if isinstance(idx, tuple) else (idx,)
        idx = tuple(torch.as_tensor(i, device=self.sh.device)
                    if isinstance(i, np.ndarray) else i for i in idx)
        return self.with_sh(self.sh[(slice(None),) + idx])

    def reshape(self, *shape) -> "Share":
        return self.derive(
            lambda sh: sh.reshape((sh.shape[0],) + tuple(shape)))


def reconstruct(sh) -> torch.Tensor:
    """Functionality-boundary reconstruction. A `Share` dispatches to its
    backend; a raw stacked tensor sums its rows."""
    if isinstance(sh, Share):
        return sh.backend.reconstruct(sh.sh)
    out = sh[0]
    for i in range(1, sh.shape[0]):
        out = out + sh[i]
    return out


def share(key: torch.Tensor, x: torch.Tensor, ring: RingSpec = RING64,
          proto: str = "2pc") -> Share:
    """Encode x in the ring and split into uniform shares. The shares
    live where `x` lives; `key` must be on the same device."""
    return share_encoded(key, ring.encode(x), ring, proto)


def share_encoded(key: torch.Tensor, enc: torch.Tensor,
                  ring: RingSpec = RING64, proto: str = "2pc",
                  fb: int | None = None) -> Share:
    """Split an already-encoded ring tensor; `fb` tags the scale the
    encoding carries (comparison bits are shared at fb=0, making the
    b*(x-y) selection multiply exact and truncation-free)."""
    from repro_torch.mpc import protocols
    return Share(protocols.get(proto).share_encoded(key, enc, ring), ring,
                 proto, fb)


def open_(x: Share, op: str = "open") -> torch.Tensor:
    """Reconstruct the ring element (1 round, backend-defined bytes),
    returned AT THE CARRIED SCALE (x.fb)."""
    comm.record(op, rounds=1, nbytes=x.backend.open_bytes(x.ring, _numel(x)),
                numel=_numel(x), tag="bw", payload=x.backend.open_msgs(x.sh))
    return reconstruct(x)


def reveal(x: Share) -> torch.Tensor:
    """Open and decode to float at the carried scale (exact — deferred
    truncation costs a revealed value nothing)."""
    return x.ring.decode_at(open_(x), x.fb)


def zeros_like(x: Share) -> Share:
    return x.with_sh(torch.zeros_like(x.sh))


def from_public(v, ring: RingSpec = RING64, proto: str = "2pc",
                fb: int | None = None) -> Share:
    """A public constant as a (trivial) share: component 0 holds it all.
    `v` is a float tensor; the share lives where it lives."""
    from repro_torch.mpc import protocols
    fb = ring.frac_bits if fb is None else fb
    return Share(protocols.get(proto).from_public(ring.encode_at(v, fb)),
                 ring, proto, fb)


def _numel(x: Share) -> int:
    n = 1
    for d in x.shape:
        n *= int(d)
    return n
