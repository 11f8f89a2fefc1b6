"""Table 2's ablations (no-sm, no-ln, no-se) of the port against the
JAX package's, on RING32. `VariantParity` is shared with
test_torch_variants64.py (the ablations on RING64) and
test_torch_baselines{32,64}.py (Table 3's baselines, quad_sm: MPCFormer
2Quad and poly_sm: Bolt polynomial); each file holds its variants, so
that no file's JAX side runs more than three variants.

The exact-op variants run the CrypTen-style protocols of
`mpc/nonlinear.py` over shares. At tests/test_engine.py's geometry
(d_model 32, 2 heads of 16, proxy <1, 2, 4>, seq 8, batch 6, 3 classes),
for each variant:

  * `proxy_entropy` over MPCEngine, eager and fused, on one batch with
    the keys the executor gives it: bitwise shares and record-for-record
    ledgers against the JAX forward (eager) and the JAX executor's run
    of that batch (fused, serial);
  * the meta probe equal to the executed forward's ledger, the port's
    and the JAX package's, record for record;
  * decoded scores against ClearEngine with the same variant: within
    test_engine.py's ATOL on RING64, printed on RING32;
  * one `score_phase` of one wave of two batches (two vmapped lanes):
    `agrees()`, and the first batch's scores bitwise equal to the JAX
    executor's on that batch alone.

`run_variants` (Fig 7's four schedule points) runs in
test_torch_run_variants.py, which needs no JAX side.

The proxy is built by the JAX package from a seed and carried across
with `core.tree.to_device`; the pool comes from numpy. The JAX executor
runs serially (its coalesced run costs minutes of XLA compiles on the
CPU); its scores are schedule-invariant by its own contract.
"""
import contextlib
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
from repro.engine import VARIANTS as J_VARIANTS
from repro.engine import proxy_entropy as j_proxy_entropy
from repro.mpc import comm as j_comm
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro.mpc.sharing import share as j_share
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import proxy, tree
from repro_torch.core.executor import ExecConfig, WaveExecutor
from repro_torch.engine import (VARIANTS, ClearEngine, MPCEngine,
                                cached_probe, proxy_entropy)
from repro_torch.mpc import comm, fusion, prng
from repro_torch.mpc.ring import RING32, RING64
from repro_torch.mpc.sharing import reveal, share

GEOM = dict(vocab_size=64, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
J_SPEC, SPEC = j_proxy.ProxySpec(1, 2, 4), proxy.ProxySpec(1, 2, 4)
SEQ, BATCH, CLASSES, WAVE = 8, 6, 3, 2
POOL = WAVE * BATCH
KEY = 7
ABLATIONS = ("no-sm", "no-ln", "no-se")
BASELINES = ("quad_sm", "poly_sm")
RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
# decoded MPC against clear, per variant: tests/test_engine.py:44-45
ATOL = {"full": 2e-3, "no-sm": 2e-2, "no-ln": 2e-2, "no-se": 6e-2,
        "quad_sm": 2e-2, "poly_sm": 2e-2}


def records(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


def _pool():
    return np.random.default_rng(1).integers(0, GEOM["vocab_size"],
                                             (POOL, SEQ))


class VariantParity:
    RING = "ring32"
    NAMES = ABLATIONS

    def pytest_generate_tests(self, metafunc):
        """Each test's `name` runs over this class's variants."""
        if "name" in metafunc.fixturenames:
            metafunc.parametrize("name", self.NAMES)

    # -- the JAX side, computed once per ring --------------------------
    @pytest.fixture(scope="class")
    def jax_side(self):
        jr, _ = RINGS[self.RING]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
            jpp = j_proxy.random_proxy(jax.random.key(0), J_CFG, J_SPEC,
                                       seq_len=SEQ, n_classes=CLASSES)
            ctx = jax.enable_x64() if jr.bits == 64 else \
                contextlib.nullcontext()
            with ctx:
                yield self._jax_results(jr, jpp, _pool(), self.NAMES)

    @staticmethod
    def _jax_results(jr, jpp, pool, names):
        """Per variant: the eager forward of the pool's first batch, and
        the JAX executor's fused run of that batch alone (serial), whose
        scores and ledger are its fused forward's. The eager forward
        takes the executor's keys, so the two read alike."""
        out = {"pp": jax.tree.map(np.asarray, jpp), "eager": {},
               "fused": {}}
        k = jax.random.key(KEY)
        pp_sh = j_proxy.share_proxy(jax.random.fold_in(k, 1), jpp, jr)
        x = jnp.take(jpp["embed"], jnp.asarray(pool[:BATCH]), axis=0) \
            * jnp.float32(GEOM["d_model"] ** 0.5)
        xs = j_share(jax.random.fold_in(k, 100), x, jr)
        k_eng = jax.random.split(jax.random.fold_in(k, 2), 1)[0]
        for name in names:
            variant = J_VARIANTS[name]
            with j_comm.ledger_scope() as led:
                ent = j_proxy_entropy(JMPCEngine(jr).with_key(k_eng), pp_sh,
                                      J_CFG, xs, J_SPEC, variant)
            out["eager"][name] = (np.asarray(ent.sh), ent.fb, records(led))
            ex = JWaveExecutor(JExecConfig(wave=1, batch=BATCH, ring=jr,
                                           coalesce=False, fuse=True))
            ent = ex.score_phase(k, jpp, J_CFG, pool[:BATCH], J_SPEC,
                                 variant)
            out["fused"][name] = (np.asarray(ent.sh),
                                  records(ex.reports[-1].ledger))
        return out

    @pytest.fixture(scope="class")
    def pp(self, jax_side):
        return tree.to_device(jax_side["pp"], device="cpu")

    @property
    def ring(self):
        return RINGS[self.RING][1]

    @pytest.fixture(scope="class")
    def forwards(self, pp):
        """The port's forward per (variant, fused), run once a class."""
        cache = {}

        def get(name, fused):
            if (name, fused) not in cache:
                cache[name, fused] = self._forward(pp, VARIANTS[name], fused)
            return cache[name, fused]
        return get

    def _forward(self, pp, variant, fused=False):
        """The pool's first batch with the executor's keys for it."""
        ring = self.ring
        k = prng.key(KEY)
        pp_sh = proxy.share_proxy(prng.fold_in(k, 1), pp, ring)
        x = pp["embed"][torch.as_tensor(_pool()[:BATCH])] \
            * float(np.float32(GEOM["d_model"] ** 0.5))
        xs = share(prng.fold_in(k, 100), x, ring)
        k_eng = prng.split(prng.fold_in(k, 2), 1)[0]
        with comm.ledger_scope() as led, fusion.flight_scope(enabled=fused):
            ent = proxy_entropy(MPCEngine(ring).with_key(k_eng), pp_sh, CFG,
                                xs, SPEC, variant)
        return ent, led

    # -- the forward ---------------------------------------------------
    @pytest.mark.parametrize("fused", [False, True])
    def test_forward_bitwise_and_ledger(self, jax_side, forwards, name,
                                        fused):
        ent, led = forwards(name, fused)
        if fused:
            want_sh, want_led = jax_side["fused"][name]
        else:
            want_sh, want_fb, want_led = jax_side["eager"][name]
            assert want_fb == self.ring.frac_bits
        np.testing.assert_array_equal(want_sh, ent.sh.numpy())
        assert ent.fb == self.ring.frac_bits
        assert records(led) == want_led

    @pytest.mark.parametrize("fused", [False, True])
    def test_probe_matches_execution(self, forwards, name, fused):
        """The meta-tensor probe equals the ledger the executed forward
        recorded, record for record (the forward's equals the JAX
        package's, whose own tests hold its eval_shape probe to it)."""
        led = cached_probe(CFG, SPEC, batch=BATCH, seq=SEQ, classes=CLASSES,
                           ring=self.ring, fused=fused,
                           variant=VARIANTS[name])
        assert records(led) == records(forwards(name, fused)[1])

    def test_decoded_against_clear(self, pp, forwards, name):
        """Decoded MPC scores against ClearEngine with the same variant:
        held to test_engine.py's ATOL on RING64; RING32's 12 fractional
        bits leave the CrypTen iterations less room, so it is printed."""
        ent, _ = forwards(name, False)
        clear = proxy_entropy(ClearEngine(), pp, CFG,
                              torch.as_tensor(_pool()[:BATCH]), SPEC,
                              VARIANTS[name])
        err = float((reveal(ent).double() - clear.double()).abs().max())
        print(f"{self.RING} {name}: max |decoded MPC - clear| = {err:.3g}")
        assert np.isfinite(err)
        if self.ring.bits == 64:
            assert err < ATOL[name], (name, err)

    # -- the executor --------------------------------------------------
    def test_score_phase(self, jax_side, pp, name):
        ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=self.ring,
                                     device="cpu"))
        ent = ex.score_phase(prng.key(KEY), pp, CFG, _pool(), SPEC,
                             VARIANTS[name])
        rep = ex.reports[-1]
        assert rep.agrees()
        assert rep.n_waves == 1 and rep.n_batches == WAVE
        # a batch's keys and masks do not depend on how many batches
        # share its wave (threefry counters run over the leading lane
        # axis), so the first lane is the JAX executor's one batch
        np.testing.assert_array_equal(jax_side["fused"][name][0],
                                      ent.sh[:, :BATCH].numpy())


class TestRing32(VariantParity):
    RING = "ring32"

