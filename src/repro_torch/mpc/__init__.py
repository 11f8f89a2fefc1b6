"""MPC substrate over torch tensors — the port of `repro.mpc`.

  prng.py        threefry-2x32, bitwise equal to jax.random's key stream
  ring.py        fixed-point ring specs (int64/f16, int32/f12)
  sharing.py     protocol-generic Share container (stacked party axis)
  protocols/     the four sharing backends: additive2pc (CrypTen-style
                 dealer Beaver), replicated3pc (dealer-free), spdz2pc
                 (MAC'd, malicious) and aby3trunc (exact trunc2)
  beaver.py      re-export of the 2pc dealer
  ops.py         linear algebra over shares: add/sub/mul/matmul/trunc
  compare.py     secure comparison (ideal-functionality semantics,
                 protocol-accurate cost: 8 rounds / 432 B per scalar)
  nonlinear.py   CrypTen-style baselines: exp, reciprocal, rsqrt, softmax,
                 log, gelu, layernorm — built from secure muls
  quickselect.py top-k index selection over encrypted scores
  comm.py        cost ledger (online + offline dealer channels) +
                 network profiles + delay model
  costs.py       analytic per-op cost formulas, ring- and protocol-
                 parameterized, and the exact mirror of the proxy stream
  scale.py       the fixed-point scale lattice
  fusion.py      flight batcher: round compression of opening flights
"""
from repro_torch.mpc.ring import RingSpec, RING64, RING32
from repro_torch.mpc.sharing import Share, share, open_, reveal
from repro_torch.mpc.comm import (Ledger, NetProfile, WAN, POD_DCN,
                                  get_ledger, ledger_scope)
from repro_torch.mpc import (ops, nonlinear, compare, beaver, protocols,
                             quickselect, prng, costs)
