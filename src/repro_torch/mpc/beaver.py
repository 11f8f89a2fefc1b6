"""Trusted-dealer correlated randomness — re-export of the dealer, which
lives in the additive-2PC protocol backend (`mpc/protocols/additive2pc.py`)
where it belongs: Beaver triples and truncation pairs are an artifact of
that trust model. Dealer-shipped bytes are recorded into the ambient
ledger's offline channel (`tag="offline"`) at generation time.
"""
from repro_torch.mpc.protocols.additive2pc import (  # noqa: F401
    matmul_triple, mul_triple, triple_bytes, trunc_pair)
