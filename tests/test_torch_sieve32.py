"""The port's private sieve against the JAX package's, on RING32
(`SieveParity` is shared with test_torch_sieve64.py for RING64).

Fusion-smoke geometry (benchmarks/bench_fusion.py:563-566: d_model 32,
2 heads of 16, proxy <1, 2, 4>, batch 8, seq 8, 2 classes; a pool of 24
and waves of 2). The proxy is built by the JAX package from a seed and
carried across with `core.tree.to_device`; the pool comes from numpy.

  * `proxy_entropy` over MPCEngine, eager and fused: bitwise shares,
    the same carried exponent, record-for-record ledgers;
  * the per-batch probe (meta tensors here, eval_shape there):
    record-for-record, and the BENCH_fusion.json["smoke"] anchors;
  * `score_phase`, coalesced and serial, eager and fused: bitwise scores
    against the JAX executor, `agrees()`, the phase ledger record for
    record, and the same `top_k_indices` survivors and appraisal.

The JAX executor runs serially here (its coalesced run costs minutes of
XLA compiles on the CPU); its scores are schedule-invariant by its own
contract, and its coalesced ledger is its probe replayed under
`comm.wave_scope(lanes)` — exactly how its vmapped wave records.
"""
import contextlib
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import proxy as j_proxy
from repro.core.executor import ExecConfig as JExecConfig
from repro.core.executor import WaveExecutor as JWaveExecutor
from repro.engine import MPCEngine as JMPCEngine, TraceEngine as JTraceEngine
from repro.engine import abstract_shares as j_abstract_shares
from repro.engine import proxy_entropy as j_proxy_entropy
from repro.mpc import comm as j_comm, fusion as j_fusion
from repro.mpc import quickselect as j_quickselect
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro.mpc.sharing import reconstruct as j_reconstruct, share as j_share
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import proxy, tree
from repro_torch.core.executor import ExecConfig, WaveExecutor
from repro_torch.engine import (ClearEngine, MPCEngine, cached_probe,
                                proxy_entropy)
from repro_torch.mpc import comm, fusion, prng, quickselect
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.mpc.sharing import reconstruct, share

GEOM = dict(vocab_size=64, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
J_SPEC, SPEC = j_proxy.ProxySpec(1, 2, 4), proxy.ProxySpec(1, 2, 4)
SEQ, CLASSES, POOL, BATCH, WAVE, KEEP = 8, 2, 24, 8, 2, 10
RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_fusion.json")


def records(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


class SieveParity:
    RING = "ring32"

    # -- the JAX side, computed once per ring --------------------------
    @pytest.fixture(scope="class")
    def jax_side(self):
        jr, _ = RINGS[self.RING]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
            jpp = j_proxy.random_proxy(jax.random.key(0), J_CFG, J_SPEC,
                                       seq_len=SEQ, n_classes=CLASSES)
            pool = np.random.default_rng(0).integers(0, GEOM["vocab_size"],
                                                     (POOL, SEQ))
            ctx = jax.enable_x64() if jr.bits == 64 else \
                contextlib.nullcontext()
            with ctx:
                yield self._jax_results(jr, jpp, pool)

    @staticmethod
    def _jax_results(jr, jpp, pool):
        out = {"pp": jax.tree.map(np.asarray, jpp), "pool": pool,
               "forward": {}, "phase": {}, "wave_ledger": {}}
        pp_sh = j_proxy.share_proxy(jax.random.key(1), jpp, jr)
        x = jnp.take(jpp["embed"], jnp.asarray(pool[:BATCH]), axis=0) \
            * jnp.float32(GEOM["d_model"] ** 0.5)
        xs = j_share(jax.random.key(2), x, jr)
        for fused in (False, True):
            with j_comm.ledger_scope() as led, \
                    j_fusion.flight_scope(enabled=fused):
                ent = j_proxy_entropy(JMPCEngine(jr).with_key(
                    jax.random.key(3)), pp_sh, J_CFG, xs, J_SPEC)
            out["forward"][fused] = (np.asarray(ent.sh), ent.fb,
                                     records(led))
            ex = JWaveExecutor(JExecConfig(wave=WAVE, batch=BATCH, ring=jr,
                                           fuse=fused, coalesce=False))
            ent = ex.score_phase(jax.random.key(7), jpp, J_CFG, pool,
                                 J_SPEC)
            rep = ex.reports[-1]
            top = j_quickselect.top_k_indices(ent, KEEP, seed=1234,
                                              wave=WAVE if fused else 1)
            vals = np.asarray(j_reconstruct(ent[np.asarray(top)]))
            out["phase"][fused] = {
                "scores": np.asarray(ent.sh), "ledger": records(rep.ledger),
                "per_batch": records(rep.per_batch), "top": top,
                "appraisal": float(np.mean(vals.astype(np.float64)
                                           / jr.scale))}
            probe = JTraceEngine(jr)
            pp_abs = j_abstract_shares(J_CFG, J_SPEC, SEQ, CLASSES, jr)
            for lanes in (1, 2):
                with j_comm.wave_scope(lanes):
                    led = probe.probe(pp_abs, J_CFG, J_SPEC,
                                      (BATCH, SEQ, GEOM["d_model"]),
                                      fused=fused)
                out["wave_ledger"][fused, lanes] = records(led)
        return out

    @pytest.fixture(scope="class")
    def pp(self, jax_side):
        return tree.to_device(jax_side["pp"], device="cpu")

    @property
    def ring(self):
        return RINGS[self.RING][1]

    # -- the forward ---------------------------------------------------
    @pytest.mark.parametrize("fused", [False, True])
    def test_forward_bitwise_and_ledger(self, jax_side, pp, fused):
        ring = self.ring
        pp_sh = proxy.share_proxy(prng.key(1), pp, ring)
        x = pp["embed"][torch.as_tensor(jax_side["pool"][:BATCH])] \
            * float(np.float32(GEOM["d_model"] ** 0.5))
        xs = share(prng.key(2), x, ring)
        with comm.ledger_scope() as led, fusion.flight_scope(enabled=fused):
            ent = proxy_entropy(MPCEngine(ring).with_key(prng.key(3)), pp_sh,
                                CFG, xs, SPEC)
        want_sh, want_fb, want_led = jax_side["forward"][fused]
        np.testing.assert_array_equal(want_sh, ent.sh.numpy())
        assert ent.fb == want_fb == ring.frac_bits
        assert records(led) == want_led

    @pytest.mark.parametrize("fused", [False, True])
    def test_probe_matches_and_smoke_anchors(self, jax_side, fused):
        """The meta-tensor probe equals the JAX eval_shape probe record
        for record and reproduces the fusion-smoke anchors."""
        led = cached_probe(CFG, SPEC, batch=BATCH, seq=SEQ, classes=CLASSES,
                           ring=self.ring, fused=fused)
        assert records(led) == jax_side["phase"][fused]["per_batch"]
        with open(BENCH) as f:
            anchor = json.load(f)["smoke"][self.RING]
        assert led.rounds == anchor["fused_rounds" if fused
                                    else "eager_rounds"]
        assert led.offline_nbytes == anchor["offline_nbytes"]
        if not fused:
            assert sum(1 for r in led.records if r.tag == "bw"
                       and "trunc" in r.op) == anchor["trunc_events"]

    # -- the executor --------------------------------------------------
    @pytest.mark.parametrize("coalesce", [True, False])
    @pytest.mark.parametrize("fused", [False, True])
    def test_score_phase(self, jax_side, pp, coalesce, fused):
        ring = self.ring
        ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=ring,
                                     fuse=fused, coalesce=coalesce,
                                     overlap=coalesce, device="cpu"))
        ent = ex.score_phase(prng.key(7), pp, CFG, jax_side["pool"], SPEC)
        rep = ex.reports[-1]
        want = jax_side["phase"][fused]
        np.testing.assert_array_equal(want["scores"], ent.sh.numpy())
        assert rep.agrees()
        if coalesce:        # waves of 2 lanes, then 1
            expect = jax_side["wave_ledger"][fused, 2] \
                + jax_side["wave_ledger"][fused, 1]
        else:
            expect = want["ledger"]
        assert records(rep.ledger) == expect
        assert rep.device.matmul_ref > 0 and rep.device.matmul_kernel == 0
        top = quickselect.top_k_indices(ent, KEEP, seed=1234,
                                        wave=WAVE if fused else 1)
        np.testing.assert_array_equal(want["top"], top)
        vals = reconstruct(ent[top]).to(torch.float64) / ring.scale
        assert float(vals.mean()) == want["appraisal"]


class TestRing32(SieveParity):
    RING = "ring32"

    def test_fused_combine_runs_through_secure_matmul(self, pp):
        """RING32 2-D products take the fused two-party combine: the
        executor's counters see secure_matmul calls (plain, on CPU)."""
        ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=RING32,
                                     device="cpu"))
        ex.score_phase(prng.key(7), pp, CFG,
                       np.zeros((BATCH, SEQ), np.int64), SPEC)
        d = ex.reports[-1].device
        assert d.combine_ref > 0 and d.combine_kernel == 0


def test_clear_engine_matches_jax_clear():
    """The float reference the MPC sieve is held against: the port's
    ClearEngine equals the JAX package's within float32 tolerance."""
    from repro.engine import ClearEngine as JClearEngine
    jpp = j_proxy.random_proxy(jax.random.key(0), J_CFG, J_SPEC,
                               seq_len=SEQ, n_classes=CLASSES)
    tok = np.random.default_rng(1).integers(0, GEOM["vocab_size"],
                                            (BATCH, SEQ))
    want = np.asarray(j_proxy_entropy(JClearEngine(), jpp, J_CFG,
                                      jnp.asarray(tok), J_SPEC))
    pp = tree.to_device(jax.tree.map(np.asarray, jpp), device="cpu")
    got = proxy_entropy(ClearEngine(), pp, CFG, torch.as_tensor(tok), SPEC)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_exec_config_refuses_missing_card_and_unported_modes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            WaveExecutor(ExecConfig())
    with pytest.raises(NotImplementedError):
        WaveExecutor(ExecConfig(device="cpu", mesh="host"))
    # the real wire is ported (ROADMAP Queue 1 item 12): a wire mode is
    # accepted and forces the eager per-lane schedule; an unknown one
    # raises
    ex = WaveExecutor(ExecConfig(device="cpu", wire="local"))
    assert ex.cfg.wire == "local" and not ex.cfg.coalesce
    with pytest.raises(ValueError, match="unknown wire mode"):
        WaveExecutor(ExecConfig(device="cpu", wire="carrier-pigeon"))
    # the other protocol backends are ported (ROADMAP Queue 1 item 11):
    # a 3pc phase runs (three share rows, its ledger agrees); only an
    # unknown protocol name raises, from the registry
    pp = proxy.random_proxy(torch.Generator().manual_seed(0), CFG, SPEC,
                            SEQ, CLASSES, device="cpu")
    ex = WaveExecutor(ExecConfig(device="cpu", protocol="3pc", batch=BATCH,
                                 wave=WAVE))
    ent = ex.score_phase(prng.key(0), pp, CFG, np.zeros((BATCH, SEQ),
                                                         np.int64), SPEC)
    assert tuple(ent.sh.shape) == (3, BATCH) and ex.reports[-1].agrees()
    with pytest.raises(ValueError, match="unknown protocol"):
        WaveExecutor(ExecConfig(device="cpu", protocol="4pc")) \
            .score_phase(prng.key(0), {}, CFG, np.zeros((1, SEQ)), SPEC)
