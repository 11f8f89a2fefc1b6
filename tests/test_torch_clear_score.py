"""The port's clear sieve scoring against the JAX package's, on the CPU:
`ClearEngine` running `engine/forward.proxy_entropy`, and the clear
phase of `core/selection` (`two_phase_default`, `_phase_keep`,
`_score_clear` and the keep/appraisal step).

Fusion-smoke geometry (d_model 32, 2 heads of 16, seq 8, 2 classes), a
JAX-built proxy carried across with `core.tree.to_device`, a numpy pool.
Float32 throughout; tolerance 1e-5 (absolute and relative) on scores and
appraisals. Survivors must be equal for every candidate whose score is
more than 1e-4 from the phase's keep threshold. The card's attention
fold (`engine/clear.mlp_attend`, the `mlp_softmax_attn` kernel's input
layout) is held here against the materialized sequence through the
kernel front's plain version. The MPC engines' op stream after the
`attend` refactor is covered record for record by test_torch_sieve32.py
and test_torch_sieve64.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import proxy as j_proxy
from repro.core import selection as j_selection
from repro.engine import ClearEngine as JClearEngine
from repro.engine import VARIANTS as J_VARIANTS
from repro.engine import proxy_entropy as j_proxy_entropy
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import proxy, selection, tree
from repro_torch.engine import VARIANTS, ClearEngine, proxy_entropy
from repro_torch.engine.clear import mlp_attend
from repro_torch.engine.forward import _mlp_at, attend_materialized
from repro_torch.kernels import ops as kops

GEOM = dict(vocab_size=64, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
SEQ, CLASSES, POOL = 8, 2, 32
TOL = dict(atol=1e-5, rtol=1e-5)


def proxies(specs, cfg=J_CFG, seed=0):
    """(JAX proxy, the port's copy) per spec."""
    out = []
    for i, (n_layers, n_heads, hid) in enumerate(specs):
        jpp = j_proxy.random_proxy(jax.random.key(seed + i), cfg,
                                   j_proxy.ProxySpec(n_layers, n_heads, hid),
                                   seq_len=SEQ, n_classes=CLASSES)
        out.append((jpp, tree.to_device(jax.tree.map(np.asarray, jpp),
                                        "cpu")))
    return out


@pytest.fixture(scope="module")
def pool():
    return np.random.default_rng(0).integers(0, GEOM["vocab_size"],
                                             (POOL, SEQ)).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_proxy_entropy_matches_jax(pool, variant):
    (jpp, pp), = proxies([(1, 2, 4)])
    spec = proxy.ProxySpec(1, 2, 4)
    kops.reset_eh_stats()
    kops.reset_msa_stats()
    got = proxy_entropy(ClearEngine(), pp, CFG, torch.as_tensor(pool[:8]),
                        spec, VARIANTS[variant])
    want = j_proxy_entropy(JClearEngine(), jpp, J_CFG, jnp.asarray(pool[:8]),
                           j_proxy.ProxySpec(1, 2, 4), J_VARIANTS[variant])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # on the CPU the engine runs its materialized sequence, no front
    assert kops.eh_stats()["ref"] == 0 and kops.msa_stats()["ref"] == 0


@pytest.mark.parametrize("n_kv,n_heads", [(2, 2), (1, 2)])
def test_mlp_attend_fold_matches_materialized(pool, n_kv, n_heads):
    """The card's MLP_sm attention input layout — heads folded into the
    kernel's batch, k / v per kv head — through the kernel front (its
    plain version here) equals the materialized attention block."""
    cfg = dataclasses.replace(CFG, n_kv_heads=n_kv)
    (_, pp), = proxies([(1, n_heads, 4)],
                       cfg=dataclasses.replace(J_CFG, n_kv_heads=n_kv))
    rng = np.random.default_rng(1)
    b, s, dh, wk, g = 3, SEQ, cfg.d_head, n_kv, n_heads // n_kv
    eng = ClearEngine()
    qT = torch.from_numpy(rng.standard_normal((b, wk, g, s, dh),
                                              dtype=np.float32))
    kT = torch.from_numpy(rng.standard_normal((b, wk, 1, dh, s),
                                              dtype=np.float32)) \
        .expand(b, wk, g, dh, s)
    v = torch.from_numpy(rng.standard_normal((b * s, wk * dh),
                                             dtype=np.float32))
    want = attend_materialized(eng, pp, 0, qT, kT, v, frozenset({"sm"}))
    kops.reset_msa_stats()
    got = mlp_attend(_mlp_at(pp["mlp_sm"], 0), qT, kT, v)
    assert kops.msa_stats() == {"kernel": 0, "ref": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_two_phase_default_matches_jax():
    for heads in (2, 12):
        got = selection.two_phase_default(heads)
        want = j_selection.two_phase_default(heads)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]


@pytest.mark.parametrize("n_pool", [10, 64, 160, 2000])
@pytest.mark.parametrize("budget", [1, 8, 40])
@pytest.mark.parametrize("sel", [(0.5,), (0.375, 1.0), (0.5, 0.25, 1.0)])
def test_phase_keep_matches_jax(n_pool, budget, sel):
    specs = [proxy.ProxySpec(1, 1, 2, selectivity=a) for a in sel]
    jspecs = [j_proxy.ProxySpec(1, 1, 2, selectivity=a) for a in sel]
    assert selection._phase_keep(n_pool, budget, specs) == \
        j_selection._phase_keep(n_pool, budget, jspecs)


@pytest.mark.parametrize("variant", ["full", "no-se"])
def test_clear_two_phase_sieve_matches_jax(pool, variant):
    """Two clear phases, 32 -> 16 -> 6, each over the JAX package's
    survivors: the port's scores against the JAX package's `_score_clear`
    (1e-5), its survivors against the JAX phase step's
    (repro/core/selection.py:241-244) for every candidate whose score is
    more than 1e-4 from the keep threshold, and its appraisal against the
    mean JAX score of the candidates it kept (1e-5). With the MLP_se
    entropy ("full") every candidate is that far from the threshold; the
    exact entropy of these near-uniform logits puts some within it."""
    shapes = [(1, 1, 2), (1, 2, 4)]
    specs = [proxy.ProxySpec(1, 1, 2, 0.5), proxy.ProxySpec(1, 2, 4)]
    jspecs = [j_proxy.ProxySpec(1, 1, 2, 0.5), j_proxy.ProxySpec(1, 2, 4)]
    keeps = selection._phase_keep(POOL, 6, specs)
    assert keeps == [16, 6]
    j_surv = np.arange(POOL)
    for (jpp, pp), spec, jspec, keep in zip(proxies(shapes, seed=3), specs,
                                            jspecs, keeps):
        jents = j_selection._score_clear(JClearEngine(), jpp, J_CFG,
                                         pool[j_surv], jspec,
                                         J_VARIANTS[variant])
        ranked = np.sort(jents)
        thr = (ranked[-keep] + ranked[-keep - 1]) / 2
        decided = np.abs(jents - thr) > 1e-4
        if variant == "full":
            assert decided.all()
        kept_j = np.isin(j_surv, np.sort(j_surv[np.argsort(jents)[-keep:]]))
        surv, app, ents = selection.clear_phase(
            ClearEngine(), pp, CFG, pool, j_surv, spec, keep,
            VARIANTS[variant], batch=5)
        np.testing.assert_allclose(ents, jents, **TOL)
        kept = np.isin(j_surv, surv)
        assert len(surv) == keep
        np.testing.assert_array_equal(kept[decided], kept_j[decided])
        np.testing.assert_allclose(app, np.mean(jents[kept]), **TOL)
        j_surv = j_surv[kept_j]
