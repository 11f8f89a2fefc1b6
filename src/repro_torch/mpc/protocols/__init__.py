"""Pluggable secret-sharing protocol backends.

  additive2pc   semi-honest 2PC, CrypTen trust model: a trusted dealer
                (crypto provider) ships Beaver triples and truncation
                pairs ahead of time — their bytes land in the ledger's
                OFFLINE channel (tag="offline", priced separately from
                the online wire).
  replicated3pc honest-majority 3PC, 2-out-of-3 replicated sharing
                (ABY3-style): multiplication is local cross-terms plus
                a correlated-PRNG zero-share resharing flight, and
                truncation is probabilistic and local — NO dealer, zero
                offline bytes.
  spdz2pc       MALICIOUS-security 2PC: SPDZ-style MAC'd additive
                shares (4 leading-axis rows: value + MAC components),
                sacrifice-authenticated Beaver triples, partial opens
                with a batched boundary MAC check, dealer truncation on
                BOTH rings — tampering aborts (MacCheckError).
  aby3trunc     replicated3pc with ABY3's EXACT two-phase `trunc2` in
                place of the probabilistic regrouped shift: <= 1 ulp
                always, zero wraps, 2 rounds per forced truncation.

A backend owns exactly the operations where the schemes differ
(`base.ProtocolBackend`); everything above this layer (`ops`,
`compare`, `nonlinear`, the engines, the executor, the analytic mirror)
is protocol-generic and routes through `get(name)`. Every integer
product of every backend runs through `kernels.ops.ring_matmul` on the
card; only the 2pc RING32 combine takes `secure_matmul`.
"""
from __future__ import annotations

from repro_torch.mpc.protocols.base import BackendDefaults, ProtocolBackend
from repro_torch.mpc.protocols.additive2pc import Additive2PC
from repro_torch.mpc.protocols.replicated3pc import Replicated3PC
from repro_torch.mpc.protocols.spdz2pc import SPDZ2PC
from repro_torch.mpc.protocols.aby3trunc import ABY3Trunc

PROTOCOLS: dict[str, ProtocolBackend] = {
    "2pc": Additive2PC(),
    "3pc": Replicated3PC(),
    "spdz2pc": SPDZ2PC(),
    "aby3trunc": ABY3Trunc(),
}


def get(name: str) -> ProtocolBackend:
    try:
        return PROTOCOLS[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol {name!r} (expected one of "
            f"{sorted(PROTOCOLS)})") from None


__all__ = ["ProtocolBackend", "BackendDefaults", "Additive2PC",
           "Replicated3PC", "SPDZ2PC", "ABY3Trunc", "PROTOCOLS", "get"]
