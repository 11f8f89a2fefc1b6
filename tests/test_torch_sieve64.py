"""The port's private sieve against the JAX package's, on RING64 (the
shared checks live in test_torch_sieve32.SieveParity), plus clear
against MPC within tests/test_engine.py's ATOL["full"] (2e-3)."""
import numpy as np
import jax
import torch

from repro.core import proxy as j_proxy
from repro_torch.core import proxy, tree
from repro_torch.engine import ClearEngine, MPCEngine, proxy_entropy
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RING64
from repro_torch.mpc.sharing import reveal, share
from test_torch_sieve32 import (BATCH, CFG, CLASSES, GEOM, J_CFG, J_SPEC,
                                SEQ, SPEC, SieveParity)

ATOL_FULL = 2e-3          # tests/test_engine.py:45


class TestRing64(SieveParity):
    RING = "ring64"


def test_clear_vs_mpc_ring64():
    jpp = j_proxy.random_proxy(jax.random.key(0), J_CFG, J_SPEC,
                               seq_len=SEQ, n_classes=CLASSES)
    pp = tree.to_device(jax.tree.map(np.asarray, jpp), device="cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, GEOM["vocab_size"], (BATCH, SEQ)))
    clear = proxy_entropy(ClearEngine(), pp, CFG, tok, SPEC)
    x = pp["embed"][tok] * float(np.float32(GEOM["d_model"] ** 0.5))
    ent = proxy_entropy(MPCEngine(RING64).with_key(prng.key(4)),
                        proxy.share_proxy(prng.key(2), pp, RING64), CFG,
                        share(prng.key(3), x, RING64), SPEC)
    err = float((reveal(ent) - clear.double()).abs().max())
    assert err < ATOL_FULL, err
