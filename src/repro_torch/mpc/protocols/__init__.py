"""Pluggable secret-sharing protocol backends.

Ported so far: `additive2pc` — semi-honest 2PC, CrypTen trust model: a
trusted dealer (crypto provider) ships Beaver triples and truncation
pairs ahead of time, and their bytes land in the ledger's OFFLINE
channel. The replicated-3PC, SPDZ and ABY3 backends of the JAX package
are named here so that asking for them fails with a clear message.
"""
from __future__ import annotations

from repro_torch.mpc.protocols.base import BackendDefaults, ProtocolBackend
from repro_torch.mpc.protocols.additive2pc import Additive2PC

PROTOCOLS: dict[str, ProtocolBackend] = {"2pc": Additive2PC()}

NOT_PORTED = ("3pc", "spdz2pc", "aby3trunc")


def get(name: str) -> ProtocolBackend:
    try:
        return PROTOCOLS[name]
    except KeyError:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"protocol {name!r} is not ported yet (only '2pc' is; "
                "ROADMAP Queue 1, item 11)"
            ) from None
        raise ValueError(
            f"unknown protocol {name!r} (expected one of "
            f"{sorted(PROTOCOLS)})") from None


__all__ = ["ProtocolBackend", "BackendDefaults", "Additive2PC", "PROTOCOLS",
           "get"]
