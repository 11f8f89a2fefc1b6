"""The protocol-backend interface every sharing scheme implements.

`Share` values carry their backend's name (`Share.proto`); the generic
layers (`mpc/ops`, `mpc/compare`, the engines) look the backend up per
value and delegate every scheme-dependent operation here. Backends are
stateless singletons — randomness always arrives as an explicit PRNG key
(mpc/prng.py) so executions stay reproducible across schedule variants
and devices.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.mpc.ring import RingSpec


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class BackendDefaults:
    """Default affine share transforms: reconstruction is the plain sum
    over the leading axis, and a public constant lands on component 0.
    Schemes whose leading axis carries non-value rows — the MAC
    components of spdz2pc — override both.

    `n_wire_parties` is the number of physical parties on the wire. It
    equals `n_parties` for plain schemes but not for MAC'd ones (spdz2pc
    stacks 4 share rows across 2 parties)."""

    n_wire_parties = 2

    # True when `trunc(shift=)` is EXACT at any shift and any carried
    # exponent (dealer pair / trunc2 subprotocol). Probabilistic local
    # truncation (additive2pc's RING64 shift, replicated3pc's
    # regrouping) wraps a share with probability ~ encoded/2**bits per
    # element, so only exact-trunc backends may defer under the
    # ring-wide 3f headroom cap (ops._headroom_bits).
    exact_trunc = False

    def reconstruct(self, sh: torch.Tensor) -> torch.Tensor:
        out = sh[0]
        for i in range(1, sh.shape[0]):
            out = out + sh[i]
        return out

    def add_public_encoded(self, sh: torch.Tensor, enc) -> torch.Tensor:
        """Out of place (`z.at[0].add` in the JAX package), so it stays
        a plain tensor op under vmap and on meta tensors."""
        return torch.cat([(sh[0] + enc).unsqueeze(0), sh[1:]])

    def open_msgs(self, sh: torch.Tensor):
        """The messages an opening of `sh` puts on the wire, as
        (src, dst, tensor) entries for `comm.record(payload=...)`."""
        return [(0, 1, sh[0]), (1, 0, sh[1])]

    def dealer_material(self, gen: torch.Generator, op: str, ring: RingSpec,
                        elems: int):
        """`elems` ring elements of dealer (offline-channel) material for
        offline op `op` — the bytes a crypto provider streams ahead of
        the phase. Every offline record (Beaver triples, truncation
        pairs) already counts its total element footprint in `numel`, so
        one uniform draw of that many ring elements is shape-correct for
        all of them. The serve/ dealer pool pre-generates these on a
        worker thread.

        Drawn on `gen`'s device from `gen`, uniform over the ring (the
        JAX package draws with a numpy Generator on the host: the bytes
        differ, their law does not). The material is outside the
        execution's threefry stream, so no score depends on it."""
        if elems <= 0:
            return None
        lo, hi = -(1 << (ring.bits - 1)), 1 << (ring.bits - 1)
        out = torch.empty(int(elems), dtype=ring.dtype, device=gen.device)
        # the int64 ring's upper end is past int64: `to=None` draws the
        # dtype's full range
        return out.random_(lo, hi if ring.bits < 64 else None,
                           generator=gen)


@runtime_checkable
class ProtocolBackend(Protocol):
    """Scheme-dependent share operations.

    `mul`/`matmul` consume and produce `sharing.Share` values and record
    their own wire flights (and, for dealer-based schemes, their offline
    bytes) into the ambient ledger; `trunc` implements the scheme's
    fixed-point truncation. Everything linear is protocol-generic and
    lives in `mpc/ops`.

    Backends targeting malicious security may also expose
    `mac_check_flight(ring)`: the engine calls it once at the forward's
    public boundary (`MPCEngine.entropy_head`) to price — and, when a
    verification scope is ambient, run — the batched MAC check.
    """

    name: str                     # registry key, also Share.proto
    n_parties: int                # leading party-axis size of Share.sh
    n_wire_parties: int           # physical parties on the wire

    def share_encoded(self, key: torch.Tensor, enc: torch.Tensor,
                      ring: RingSpec) -> torch.Tensor: ...

    def from_public(self, enc: torch.Tensor) -> torch.Tensor:
        """Trivial sharing of a public ring element."""
        ...

    def open_bytes(self, ring: RingSpec, n: int) -> int: ...

    def reconstruct(self, sh: torch.Tensor) -> torch.Tensor: ...

    def add_public_encoded(self, sh: torch.Tensor, enc) -> torch.Tensor: ...

    def mul(self, x, y, key: torch.Tensor): ...

    def matmul(self, x, y, key: torch.Tensor, *,
               fused_combine: bool = False): ...

    def trunc(self, x, key: torch.Tensor | None, *,
              shift: int | None = None): ...
