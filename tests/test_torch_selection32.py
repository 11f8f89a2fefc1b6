"""The port's `run_selection` in mode="mpc" against the JAX package's on
RING32 (`SelectionMPC` is shared with test_torch_selection64.py for
RING64), with the JAX-built proxies injected (test_torch_selection_clear
.inject, test only), at test_torch_selection_clear's geometry: the
executor in waves of 2 batches of 8, serial (the JAX executor's coalesced
run costs minutes of XLA compiles on the CPU; scores do not depend on
the schedule).

Bitwise: the bootstrap draw, every phase's score shares, the survivors,
the appraisal (a float64 mean of the reconstructed scores) and the
fingerprint (read from the phase checkpoints). Resume from the
checkpoints reproduces them. `appraise_threshold` reveals the same bit
as JAX's on the same shares, at thresholds on either side of the mean.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import selection as j_sel
from repro.core.executor import ExecConfig as JExecConfig
from repro.mpc import sharing as j_sharing
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro_torch.core import proxy, selection
from repro_torch.core.executor import ExecConfig
from repro_torch.mpc import prng, sharing
from repro_torch.mpc.ring import RING32, RING64
from test_torch_selection_clear import (CFG, CLASSES, KEY, assert_same_selection,
                                        inject, j_specs, jax_proxies, pool,
                                        run_both, specs, targets)

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
EXEC = dict(wave=2, batch=8, coalesce=False)

__all__ = ["jax_proxies", "pool", "targets"]   # module fixtures, reused


class SelectionMPC:
    RING = "ring32"

    @pytest.fixture
    def x64(self, monkeypatch):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)

    def test_mpc_run_matches_jax_bitwise(self, monkeypatch, x64, targets,
                                         pool, jax_proxies, tmp_path):
        jr, pr = RINGS[self.RING]
        inject(monkeypatch, jax_proxies)
        jres, pres = run_both(
            targets, pool,
            j_sel.SelectionConfig(j_specs(), mode="mpc", score_batch=8,
                                  checkpoint_dir=str(tmp_path / "j"),
                                  executor=JExecConfig(ring=jr, **EXEC)),
            selection.SelectionConfig(specs(), mode="mpc", score_batch=8,
                                      checkpoint_dir=str(tmp_path / "p"),
                                      executor=ExecConfig(ring=pr,
                                                          device="cpu",
                                                          **EXEC)))
        assert_same_selection(jres, pres)
        assert len(pres.phase_scores) == len(jres.phase_scores) == 2
        for a, b in zip(pres.phase_scores, jres.phase_scores):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert len(pres.exec_reports) == 2
        assert all(r.agrees() for r in pres.exec_reports)
        for ph in (0, 1):
            j, p = (json.loads((tmp_path / d / f"phase_{ph}.json")
                               .read_text()) for d in ("j", "p"))
            assert p == j
        # resume: both phases restored from the checkpoints
        again = selection.run_selection(
            prng.key(KEY), targets[1], CFG, pool[0],
            selection.SelectionConfig(specs(), mode="mpc", score_batch=8,
                                      checkpoint_dir=str(tmp_path / "p"),
                                      executor=ExecConfig(ring=pr,
                                                          device="cpu",
                                                          **EXEC)),
            n_classes=CLASSES, boot_labels_fn=lambda i: pool[1][i])
        assert again.resumed_phases == 2 and again.exec_reports == []
        assert_same_selection(pres, again)

    @pytest.mark.parametrize("shift", [-0.5, 0.5])
    def test_appraise_threshold_bit_matches_jax(self, x64, shift):
        jr, pr = RINGS[self.RING]
        ents = np.random.default_rng(5).uniform(0.2, 0.7, 24) \
            .astype(np.float32)
        idx = np.array([1, 4, 7, 9, 15, 22])
        thr = float(ents[idx].mean()) + shift * 0.1
        with jax.enable_x64(jr.bits == 64):
            jsh = j_sharing.share(jax.random.key(8), jnp.asarray(ents), jr)
            want = j_sel.appraise_threshold(jsh, idx, thr,
                                            jax.random.key(9))
            sh = np.asarray(jsh.sh)
        got = selection.appraise_threshold(
            sharing.Share(torch.tensor(sh), pr), idx, thr, prng.key(9))
        assert got == want == (shift < 0)


class TestRing32(SelectionMPC):
    RING = "ring32"
