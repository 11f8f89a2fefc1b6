"""The port's selection driver (`core/selection.py`) against the JAX
package's, on the CPU, in mode="clear" (the MPC runs are
test_torch_selection32.py and test_torch_selection64.py, which share the
helpers here).

Geometry: TINY_TARGET cut to 2 layers, d_model 64, 4 heads of 16,
vocab 256; seq 16, a pool of 64 (8 bootstrap rows, a budget of 13), the
phases <1,1,2> then <2,4,4>, 2 classes. The target is built by the JAX
package from a seed and carried across; the pool and labels come from
numpy.

Training is kept apart from the driver: `inject` monkeypatches (in the
test only) both packages' `target.finetune`, `proxy.collect_stats`,
`proxy.build_proxy` and `proxy.invivo_finetune` so every phase gets the
same JAX-built proxy. Then the bootstrap draw, the survivors and the
fingerprint are equal to JAX's and the appraisal (a mean of float32
entropies scored by two frameworks) within 1e-5 relative. One run with
nothing patched (3 training steps each) is held allclose: the same
bootstrap and survivors, the appraisal within 1e-3 relative. Resume from a phase
checkpoint gives the first run's result, and the checkpoints hold JAX's
survivors and fingerprint.
"""
import dataclasses
import json

import numpy as np
import jax
import pytest

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import proxy as j_proxy
from repro.core import selection as j_sel
from repro.core import target as j_target
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import proxy, selection, target, tree
from repro_torch.core.executor import ExecConfig
from repro_torch.mpc import prng

GEOM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
            d_ff=128, vocab_size=256)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
SEQ, POOL, CLASSES = 16, 64, 2
SPECS = ((1, 1, 2, 0.5), (2, 4, 4, 1.0))
KEY = 11


def j_specs():
    return [j_proxy.ProxySpec(*s) for s in SPECS]


def specs():
    return [proxy.ProxySpec(*s) for s in SPECS]


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(3)
    return (rng.integers(0, GEOM["vocab_size"], (POOL, SEQ)),
            rng.integers(0, CLASSES, POOL))


@pytest.fixture(scope="module")
def targets():
    jp = j_target.init_classifier(jax.random.key(0), J_CFG, CLASSES)
    return jp, tree.to_device(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def jax_proxies():
    """One JAX-built proxy per phase spec (n_layers, n_heads, mlp_dim)."""
    return {s[:3]: j_proxy.random_proxy(jax.random.key(20 + i), J_CFG,
                                        j_proxy.ProxySpec(*s[:3]), SEQ,
                                        CLASSES)
            for i, s in enumerate(SPECS)}


def inject(monkeypatch, jax_proxies):
    """Both packages' training steps replaced by the JAX-built proxies
    (test only): finetune and in-vivo return their input, build_proxy
    the proxy of the phase's spec."""
    port = {k: tree.to_device(jax.tree.map(np.asarray, v), "cpu")
            for k, v in jax_proxies.items()}
    for mod_t, mod_p, pps in ((j_target, j_proxy, jax_proxies),
                              (target, proxy, port)):
        monkeypatch.setattr(mod_t, "finetune",
                            lambda key, p, *a, **kw: (p, 0.0))
        monkeypatch.setattr(mod_p, "collect_stats", lambda *a, **kw: None)
        monkeypatch.setattr(
            mod_p, "build_proxy",
            lambda key, pg, cfg, stats, ph, *a, pps=pps, **kw:
            dict(pps[(ph.n_layers, ph.n_heads, ph.mlp_dim)]))
        monkeypatch.setattr(mod_p, "invivo_finetune",
                            lambda key, pp, *a, **kw: pp)


def run_both(targets, pool, j_cfg, p_cfg):
    jp, pp = targets
    tok, lab = pool
    jres = j_sel.run_selection(jax.random.key(KEY), jp, J_CFG, tok, j_cfg,
                               n_classes=CLASSES,
                               boot_labels_fn=lambda i: lab[i])
    pres = selection.run_selection(prng.key(KEY), pp, CFG, tok, p_cfg,
                                   n_classes=CLASSES,
                                   boot_labels_fn=lambda i: lab[i])
    return jres, pres


def assert_same_selection(jres, pres, appraisal_rtol=0.0):
    np.testing.assert_array_equal(pres.boot_idx, jres.boot_idx)
    assert len(pres.phase_survivors) == len(jres.phase_survivors) == 2
    for a, b in zip(pres.phase_survivors, jres.phase_survivors):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pres.selected, jres.selected)
    if appraisal_rtol:
        np.testing.assert_allclose(pres.appraisal_entropy,
                                   jres.appraisal_entropy,
                                   rtol=appraisal_rtol)
    else:
        assert pres.appraisal_entropy == jres.appraisal_entropy


def test_phase_keeps_and_bootstrap_geometry():
    assert selection._phase_keep(POOL - 8, 13 - 8, specs()) == [28, 5]


def test_clear_run_with_injected_proxies_matches_jax(monkeypatch, targets,
                                                     pool, jax_proxies,
                                                     tmp_path):
    inject(monkeypatch, jax_proxies)
    jres, pres = run_both(
        targets, pool,
        j_sel.SelectionConfig(j_specs(), checkpoint_dir=str(tmp_path / "j")),
        selection.SelectionConfig(specs(),
                                  checkpoint_dir=str(tmp_path / "p")))
    assert_same_selection(jres, pres, appraisal_rtol=1e-5)
    assert pres.resumed_phases == 0 and pres.phase_scores == []
    # the checkpoints: JAX's survivors and fingerprint
    for ph in (0, 1):
        j, p = (json.loads((tmp_path / d / f"phase_{ph}.json").read_text())
                for d in ("j", "p"))
        assert p["fp"] == j["fp"] and p["surviving"] == j["surviving"]
    # resume: both phases restored, the same result, no training run
    monkeypatch.setattr(proxy, "build_proxy", None)
    again = selection.run_selection(
        prng.key(KEY), targets[1], CFG, pool[0],
        selection.SelectionConfig(specs(),
                                  checkpoint_dir=str(tmp_path / "p")),
        n_classes=CLASSES, boot_labels_fn=lambda i: pool[1][i])
    assert again.resumed_phases == 2
    assert_same_selection(pres, again)
    assert selection.resume_phase(selection.SelectionConfig(
        specs(), checkpoint_dir=str(tmp_path / "p")))[0] == 1


@pytest.mark.parametrize("mode", ["clear", "mpc"])
def test_run_fingerprint_equals_jax(targets, pool, mode):
    """The hex digest hashes the same bytes in the same order: target
    leaves in pytree order, the pool, the config description."""
    from repro.core.executor import ExecConfig as JExecConfig
    from repro.mpc.ring import RING32 as J_RING32
    from repro_torch.mpc.ring import RING32
    jcfg = j_sel.SelectionConfig(j_specs(), mode=mode, executor=JExecConfig(
        wave=2, batch=8, ring=J_RING32, coalesce=False))
    pcfg = selection.SelectionConfig(specs(), mode=mode, executor=ExecConfig(
        wave=2, batch=8, ring=RING32, coalesce=False, device="cpu"))
    boot = np.array([1, 5, 9, 20, 33, 40, 50, 63])
    want = j_sel._run_fingerprint(jcfg, POOL, 13, boot, targets[0], pool[0])
    got = selection._run_fingerprint(pcfg, POOL, 13, boot, targets[1],
                                     pool[0])
    assert got == want
    other = selection._run_fingerprint(pcfg, POOL, 12, boot, targets[1],
                                       pool[0])
    assert other != want


def test_untouched_clear_run_close_to_jax(targets, pool):
    """Nothing patched: M_g's finetune, the stats, the ex-vivo fits and
    the in-vivo finetune (3 steps each) feed the sieve on both sides."""
    steps = dict(finetune_steps=3, exvivo_steps=3, invivo_steps=3)
    jres, pres = run_both(targets, pool,
                          j_sel.SelectionConfig(j_specs(), **steps),
                          selection.SelectionConfig(specs(), **steps))
    assert_same_selection(jres, pres, appraisal_rtol=1e-3)
