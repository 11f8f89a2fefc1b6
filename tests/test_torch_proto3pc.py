"""An executed phase of the port's replicated3pc backend against the JAX
package's, on RING64. `ProtocolPhase` is shared with
test_torch_protoaby3.py (aby3trunc) and test_torch_protospdz.py
(spdz2pc); each file holds one backend, so that no file's JAX side runs
more than one executed protocol.

At tests/test_engine.py's geometry (d_model 32, 2 heads of 16, proxy
<1, 2, 4>, seq 8, batch 6, 3 classes), the proxy built by the JAX
package from a seed and shared under the backend:

  * `proxy_entropy` over MPCEngine(protocol=...) on one batch with the
    keys the executor gives it: bitwise shares, the ledger record for
    record and the wire payloads message for message against the JAX
    forward; the meta probe equal to that ledger;
  * `score_phase` of one wave of two batches (two vmapped lanes), eager
    and fused: `agrees()`, the per-batch ledger equal to
    `costs.proxy_exec_cost` (the port's and the JAX package's), the
    first batch's shares bitwise the JAX executor's on that batch alone
    (eager: the JAX eager forward; fused: its fused executor, serial),
    eager and fused scores bitwise equal, the backend's share rows and
    offline channel, and the decoded scores within 1e-3 of ClearEngine.

The JAX executor runs serially (its coalesced run costs minutes of XLA
compiles on the CPU); its scores are schedule-invariant by its own
contract.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import proxy as j_proxy
from repro.core.executor import ExecConfig as JExecConfig
from repro.core.executor import WaveExecutor as JWaveExecutor
from repro.engine import MPCEngine as JMPCEngine
from repro.engine import proxy_entropy as j_proxy_entropy
from repro.mpc import comm as j_comm, costs as j_costs
from repro.mpc.ring import RING64 as J_RING64
from repro.mpc.sharing import share as j_share
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import proxy, tree
from repro_torch.core.executor import ExecConfig, WaveExecutor
from repro_torch.engine import (ClearEngine, MPCEngine, cached_probe,
                                proxy_entropy)
from repro_torch.mpc import comm, costs, fusion, prng, protocols
from repro_torch.mpc.ring import RING64
from repro_torch.mpc.sharing import share

GEOM = dict(vocab_size=64, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
J_SPEC, SPEC = j_proxy.ProxySpec(1, 2, 4), proxy.ProxySpec(1, 2, 4)
SEQ, BATCH, CLASSES, WAVE = 8, 6, 3, 2
POOL = WAVE * BATCH
KEY = 7


def records(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


def stream(led):
    """What the probe and the mirror share (the mirror names its sites)."""
    return [(r.rounds, r.nbytes, r.numel, r.flops, r.tag)
            for r in led.records]


def flights(tape):
    return [(f.op, f.rounds, f.nbytes, f.tag,
             [(m.src, m.dst, m.data, m.rnd) for m in f.msgs])
            for f in tape.flights]


def _pool():
    return np.random.default_rng(1).integers(0, GEOM["vocab_size"],
                                             (POOL, SEQ))


class ProtocolPhase:
    PROTO = "3pc"

    # -- the JAX side, computed once a class ---------------------------
    @pytest.fixture(scope="class")
    def jax_side(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
            jpp = j_proxy.random_proxy(jax.random.key(0), J_CFG, J_SPEC,
                                       seq_len=SEQ, n_classes=CLASSES)
            with jax.enable_x64():
                yield self._jax_results(jpp, _pool())

    def _jax_results(self, jpp, pool):
        """The eager forward of the pool's first batch with the
        executor's keys (its ledger and wire tape), and the JAX
        executor's fused run of that batch alone (serial)."""
        proto, jr = self.PROTO, J_RING64
        k = jax.random.key(KEY)
        pp_sh = j_proxy.share_proxy(jax.random.fold_in(k, 1), jpp, jr, proto)
        x = jnp.take(jpp["embed"], jnp.asarray(pool[:BATCH]), axis=0) \
            * jnp.float32(GEOM["d_model"] ** 0.5)
        xs = j_share(jax.random.fold_in(k, 100), x, jr, proto)
        k_eng = jax.random.split(jax.random.fold_in(k, 2), 1)[0]
        tape = j_comm.WireTape(protocols.get(proto).n_wire_parties)
        with j_comm.ledger_scope() as led, j_comm.wire_tape_scope(tape):
            ent = j_proxy_entropy(JMPCEngine(jr, protocol=proto)
                                  .with_key(k_eng), pp_sh, J_CFG, xs, J_SPEC)
        out = {"pp": jax.tree.map(np.asarray, jpp),
               "eager": (np.asarray(ent.sh), ent.fb, records(led),
                         flights(tape))}
        ex = JWaveExecutor(JExecConfig(wave=1, batch=BATCH, ring=jr,
                                       protocol=proto, coalesce=False,
                                       fuse=True))
        ent = ex.score_phase(k, jpp, J_CFG, pool[:BATCH], J_SPEC)
        out["fused"] = (np.asarray(ent.sh), records(ex.reports[-1].ledger))
        out["mirror"] = {fused: stream(j_costs.proxy_exec_cost(
            BATCH, SEQ, GEOM["d_model"], 2, 2, 16, 4, CLASSES, 1, ring=jr,
            protocol=proto, fused=fused)) for fused in (False, True)}
        return out

    @pytest.fixture(scope="class")
    def pp(self, jax_side):
        return tree.to_device(jax_side["pp"], device="cpu")

    @pytest.fixture(scope="class")
    def phases(self, pp):
        """The port's executed phase, eager and fused."""
        out = {}
        for fused in (False, True):
            ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=RING64,
                                         protocol=self.PROTO, fuse=fused,
                                         device="cpu"))
            ent = ex.score_phase(prng.key(KEY), pp, CFG, _pool(), SPEC)
            out[fused] = (ent, ex.reports[-1])
        return out

    def _forward(self, pp, tape=None):
        """The pool's first batch with the executor's keys for it."""
        proto = self.PROTO
        k = prng.key(KEY)
        pp_sh = proxy.share_proxy(prng.fold_in(k, 1), pp, RING64, proto)
        x = pp["embed"][torch.as_tensor(_pool()[:BATCH])] \
            * float(np.float32(GEOM["d_model"] ** 0.5))
        xs = share(prng.fold_in(k, 100), x, RING64, proto)
        k_eng = prng.split(prng.fold_in(k, 2), 1)[0]
        with comm.ledger_scope() as led, comm.wire_tape_scope(tape):
            ent = proxy_entropy(MPCEngine(RING64, protocol=proto)
                                .with_key(k_eng), pp_sh, CFG, xs, SPEC)
        return ent, led

    # -- the forward ---------------------------------------------------
    def test_forward_bitwise_ledger_and_payloads(self, jax_side, pp):
        tape = comm.WireTape(protocols.get(self.PROTO).n_wire_parties)
        ent, led = self._forward(pp, tape)
        want_sh, want_fb, want_led, want_tape = jax_side["eager"]
        np.testing.assert_array_equal(want_sh, ent.sh.numpy())
        assert ent.fb == want_fb == RING64.frac_bits
        assert records(led) == want_led
        assert flights(tape) == want_tape
        probe = cached_probe(CFG, SPEC, batch=BATCH, seq=SEQ,
                             classes=CLASSES, ring=RING64,
                             protocol=self.PROTO, fused=False)
        assert records(probe) == records(led)

    # -- the executor --------------------------------------------------
    @pytest.mark.parametrize("fused", [False, True])
    def test_phase_agrees_with_mirror_and_jax(self, jax_side, phases, fused):
        ent, rep = phases[fused]
        assert rep.agrees()
        assert (rep.n_waves, rep.n_batches, rep.protocol) == \
            (1, WAVE, self.PROTO)
        mirror = costs.proxy_exec_cost(
            BATCH, SEQ, CFG.d_model, SPEC.n_heads, CFG.n_kv_heads,
            CFG.d_head, SPEC.mlp_dim, CLASSES, SPEC.n_layers, ring=RING64,
            protocol=self.PROTO, fused=fused)
        assert stream(rep.per_batch) == stream(mirror) == \
            jax_side["mirror"][fused]
        # a batch's keys and masks do not depend on how many batches
        # share its wave, so the first lane is the JAX side's one batch
        want = jax_side["fused" if fused else "eager"][0]
        np.testing.assert_array_equal(want, ent.sh[:, :BATCH].numpy())
        if fused:
            assert records(rep.per_batch) == \
                [r[:-1] + (1,) for r in jax_side["fused"][1]]

    def test_phase_layout_offline_and_fusion(self, phases):
        (eager, rep_e), (fused, rep_f) = phases[False], phases[True]
        be = protocols.get(self.PROTO)
        assert tuple(fused.sh.shape) == (be.n_parties, POOL)
        assert torch.equal(eager.sh, fused.sh)
        assert rep_f.ledger.rounds < rep_e.ledger.rounds
        assert rep_f.ledger.nbytes == rep_e.ledger.nbytes
        self.check_ledger(rep_e.ledger)

    def check_ledger(self, led):
        """The dealer-free backends: no offline record, no Beaver open,
        no dealer truncation."""
        assert led.offline_nbytes == 0
        assert not [r.op for r in led.records
                    if r.tag == "offline" or r.op.startswith(
                        ("offline", "beaver", "trunc_open"))]

    def test_scores_match_clear(self, pp, phases):
        clear = proxy_entropy(ClearEngine(), pp, CFG,
                              torch.as_tensor(_pool()), SPEC).double()
        be = protocols.get(self.PROTO)
        got = RING64.decode(be.reconstruct(phases[True][0].sh))
        assert float((got - clear).abs().max()) < 1e-3


class Test3PC(ProtocolPhase):
    PROTO = "3pc"
