"""The port's clear-side training against the JAX package's, on the CPU:
`core/approx` (GaussStats, fit_mlp and the four fit_*_mlp),
`core/target.finetune`, `core/proxy` (extract_backbone, collect_stats,
prune, build_proxy, invivo_finetune), and the plain backward versions of
the two attention kernels against `jax.vjp` of repro.kernels.ref.

Small geometry: TINY_TARGET cut to 2 layers, d_model 64, 4 heads of 16,
d_ff 128, vocab 256; seq 16, 2 classes, 16 bootstrap rows; a few steps.
Parameters are built by the JAX package from a seed and carried across
(`core.tree.to_device`); other inputs come from numpy. Each JAX
reference is built once per module, in a fixture.

Tolerances: batch indices bitwise (`prng.randint`); the synthesized
Gaussian inputs within test_torch_prng's NORMAL_ULP of jax's normal
(scaled by sigma, plus mu); statistics 1e-5 (absolute and relative);
per-step losses 1e-5 and parameters 1e-4 absolute on every element
(float32 Adam over gradients summed in two frameworks' orders);
the plain backward versions 1e-5 in float32 against jax.vjp (the
wrapper's sums of the backward kernel's partials 1e-5 of max(1, max
|plain|)), and gradcheck in float64.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import approx as j_approx
from repro.core import proxy as j_proxy
from repro.core import target as j_target
from repro.kernels import ref as j_ref
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import approx, proxy, target, tree
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import mlp_softmax_attn as msa
from repro_torch.kernels import ref
from repro_torch.mpc import prng

GEOM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
            d_ff=128, vocab_size=256)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
SEQ, CLASSES, N_BOOT = 16, 2, 16
J_SPEC, SPEC = j_proxy.ProxySpec(2, 4, 4), proxy.ProxySpec(2, 4, 4)
STEPS = 3
STAT_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-5, rtol=0)
PARAM_TOL = dict(atol=1e-4, rtol=0)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def record_losses(monkeypatch) -> list:
    """Every training step's loss, as a float list filled while the test
    runs: `models.common.cross_entropy` wrapped (test only)."""
    from repro_torch.models import common
    fn, out = common.cross_entropy, []

    def logged(*a, **kw):
        loss = fn(*a, **kw)
        out.append(float(loss.detach()))
        return loss
    monkeypatch.setattr(common, "cross_entropy", logged)
    return out


def close_trees(got, want, **tol):
    g, w = tree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.integers(0, GEOM["vocab_size"], (N_BOOT, SEQ)),
            rng.integers(0, CLASSES, N_BOOT))


@pytest.fixture(scope="module")
def jparams():
    return j_target.init_classifier(jax.random.key(0), J_CFG, CLASSES)


@pytest.fixture(scope="module")
def params(jparams):
    return tree.to_device(np_tree(jparams), "cpu")


# ---------------------------------------------------------------------------
# approx: statistics and ex-vivo fits
# ---------------------------------------------------------------------------

def test_gauss_stats_estimate_and_sample():
    x = np.random.default_rng(1).normal(size=(50, 7)).astype(np.float32) * 3
    js = j_approx.GaussStats.estimate(jnp.asarray(x))
    ts = approx.GaussStats.estimate(torch.from_numpy(x))
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), **STAT_TOL)
    np.testing.assert_allclose(ts.sigma.numpy(), np.asarray(js.sigma),
                               **STAT_TOL)
    want = np.asarray(js.sample(jax.random.key(4), 256))
    got = approx.GaussStats(torch.tensor(np.asarray(js.mu)),
                            torch.tensor(np.asarray(js.sigma))) \
        .sample(prng.key(4), 256).numpy()
    # prng.normal is within 3 ulp of jax's; sigma * n + mu keeps that
    # relative to the draw
    bound = 4 * np.finfo(np.float32).eps * (np.abs(want) + 3 * 3.0)
    assert (np.abs(got - want) <= bound).all()


def test_init_mlp_from_key_matches_jax():
    want = j_approx.init_mlp(jax.random.key(9), 16, 4, 16)
    got = approx.init_mlp_from_key(prng.key(9), 16, 4, 16)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=4e-7, atol=1e-9)


FITS = {
    # name: (port fn, JAX fn, stats dim, extra args)
    "softmax": (approx.fit_softmax_mlp, j_approx.fit_softmax_mlp, SEQ,
                (SEQ, 4)),
    "rsqrt": (approx.fit_rsqrt_mlp, j_approx.fit_rsqrt_mlp, 1, (4,)),
    "entropy": (approx.fit_entropy_mlp, j_approx.fit_entropy_mlp, CLASSES,
                (CLASSES, 4)),
    "gate": (approx.fit_gate_mlp, j_approx.fit_gate_mlp, 8, (8, 4)),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_mlp_matches_jax(name):
    """Each fit_*_mlp from the same key and statistics: the same initial
    weights and batches (up to normal's ulps), final parameters
    allclose. The entropy target is the port's m + log z - s/z against
    JAX's -sum p log(p + 1e-9), within n_classes * 1e-9."""
    fn, jfn, d, args = FITS[name]
    rng = np.random.default_rng(2)
    mu = rng.normal(size=d).astype(np.float32)
    sigma = (np.abs(rng.normal(size=d)) + 0.5).astype(np.float32)
    want = jfn(jax.random.key(3), j_approx.GaussStats(jnp.asarray(mu),
                                                      jnp.asarray(sigma)),
               *args, steps=5, batch=64)
    got = fn(prng.key(3), approx.GaussStats(torch.from_numpy(mu),
                                            torch.from_numpy(sigma)),
             *args, steps=5, batch=64)
    assert not any(x.requires_grad for x in got.values())
    close_trees(got, want, **PARAM_TOL)


def test_op_softmax_entropy_close_to_jax():
    x = np.random.default_rng(3).normal(size=(64, CLASSES)) \
        .astype(np.float32) * 3
    want = np.asarray(j_approx.op_softmax_entropy(jnp.asarray(x)))
    got = approx.op_softmax_entropy(torch.from_numpy(x).requires_grad_())
    assert got.shape == want.shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=CLASSES * 1e-9 + 1e-6)


# ---------------------------------------------------------------------------
# target.finetune
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_finetune(jparams, data):
    """JAX's finetune after 1..STEPS steps: its per-step losses (the loss
    it returns is the last step's) and its final parameters."""
    tok, lab = data
    losses, out = [], None
    for s in range(1, STEPS + 1):
        out, loss = j_target.finetune(jax.random.key(5), jparams, J_CFG,
                                      jnp.asarray(tok), jnp.asarray(lab),
                                      steps=s, batch=8, n_layers=2)
        losses.append(loss)
    return losses, np_tree(out)


def test_finetune_batch_indices_bitwise(data):
    jk, tk = jax.random.key(5), prng.key(5)
    for _ in range(STEPS):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk).unbind(-2)
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jsub, (8,), 0, N_BOOT)),
            prng.randint(tsub, (8,), 0, N_BOOT).numpy())


def test_finetune_matches_jax(params, data, jax_finetune, monkeypatch):
    tok, lab = data
    want_losses, want = jax_finetune
    losses = record_losses(monkeypatch)
    got, loss = target.finetune(prng.key(5), params, CFG, tok, lab,
                                steps=STEPS, batch=8, n_layers=2)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert loss == losses[-1]
    assert not any(x.requires_grad for x in tree.tree_leaves(got))
    close_trees(got, want, **PARAM_TOL)
    # the input tree is untouched (JAX arrays are immutable)
    close_trees(params, jax.tree.map(np.asarray, j_target.init_classifier(
        jax.random.key(0), J_CFG, CLASSES)), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# proxy construction
# ---------------------------------------------------------------------------

def test_extract_backbone_and_prune_match_jax(jparams, params):
    jg, g = j_proxy.extract_backbone(jparams, 1), proxy.extract_backbone(
        params, 1)
    close_trees(g, jg, atol=0, rtol=0)
    close_trees(proxy.prune(params, CFG, proxy.ProxySpec(1, 2, 4)),
                j_proxy.prune(jparams, J_CFG, j_proxy.ProxySpec(1, 2, 4)),
                atol=0, rtol=0)


@pytest.fixture(scope="module")
def jstats(jparams, data):
    return j_proxy.collect_stats(jparams, J_CFG, jnp.asarray(data[0]),
                                 J_SPEC)


def port_stats(js):
    def conv(s):
        return approx.GaussStats(torch.tensor(np.asarray(s.mu)),
                                 torch.tensor(np.asarray(s.sigma)))
    return {"sm": [conv(s) for s in js["sm"]],
            "ln": [conv(s) for s in js["ln"]], "se": conv(js["se"])}


def test_collect_stats_matches_jax(params, data, jstats):
    got = proxy.collect_stats(params, CFG, data[0], SPEC)
    for key in ("sm", "ln"):
        assert len(got[key]) == len(jstats[key]) == SPEC.n_layers
        for g, w in zip(got[key], jstats[key]):
            np.testing.assert_allclose(g.mu.numpy(), np.asarray(w.mu),
                                       atol=1e-5, rtol=1e-4)
            np.testing.assert_allclose(g.sigma.numpy(), np.asarray(w.sigma),
                                       atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["se"].mu.numpy(),
                               np.asarray(jstats["se"].mu), **STAT_TOL)


@pytest.fixture(scope="module")
def jproxy(jparams, jstats):
    return j_proxy.build_proxy(jax.random.key(6), jparams, J_CFG, jstats,
                               J_SPEC, seq_len=SEQ, n_classes=CLASSES,
                               exvivo_steps=STEPS)


def test_build_proxy_matches_jax(params, jstats, jproxy):
    """Same stats in, so the fits see the same Gaussians: the keys split
    2i / 2i + 1 / last as JAX splits them."""
    got = proxy.build_proxy(prng.key(6), params, CFG, port_stats(jstats),
                            SPEC, seq_len=SEQ, n_classes=CLASSES,
                            exvivo_steps=STEPS)
    close_trees(got, jproxy, **PARAM_TOL)


def test_invivo_finetune_matches_jax(jproxy, data, monkeypatch):
    tok, lab = data
    want = np_tree(j_proxy.invivo_finetune(
        jax.random.key(7), dict(jproxy), J_CFG, jnp.asarray(tok),
        jnp.asarray(lab), J_SPEC, steps=STEPS, batch=8))
    pp = tree.to_device(np_tree(jproxy), "cpu")
    losses = record_losses(monkeypatch)
    got = proxy.invivo_finetune(prng.key(7), pp, CFG, tok, lab, SPEC,
                                steps=STEPS, batch=8)
    assert len(losses) == STEPS and "mlp_se" in pp
    assert not any(x.requires_grad for x in tree.tree_leaves(got))
    close_trees(got, want, **PARAM_TOL)


# ---------------------------------------------------------------------------
# the attention kernels' plain backward versions
# ---------------------------------------------------------------------------

def _rand(seed, shape, scale=1.0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(dtype)


@pytest.mark.parametrize("causal,group", [(False, 1), (True, 1), (False, 2)])
def test_flash_attn_backward_matches_jax_vjp(causal, group):
    q, k, v, do = (_rand(i, s) for i, s in enumerate(
        [(4, 12, 16), (4 // group, 12, 16), (4 // group, 12, 16),
         (4, 12, 16)]))
    rep = (lambda x: jnp.repeat(x, group, axis=0))
    _, vjp = jax.vjp(lambda q, k, v: j_ref.flash_attn(q, rep(k), rep(v),
                                                      causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.reset_bwd_stats()
    out = fa.flash_attn(*ins, causal=causal)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    assert fa.bwd_stats() == {"kernel": 0, "ref": 1}
    plain = torch.autograd.grad(ref.flash_attn(*ins, causal=causal), ins,
                                torch.from_numpy(do))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("group", [1, 3])
def test_mlp_softmax_attn_backward_matches_jax_vjp(group):
    q, k, v, do = (_rand(i, s) for i, s in enumerate(
        [(6, 10, 16), (6 // group, 10, 16), (6 // group, 10, 16),
         (6, 10, 16)]))
    w = [_rand(10 + i, s, sc) for i, (s, sc) in enumerate(
        [((10, 3), 0.3), ((3,), 0.1), ((3, 10), 0.3), ((10,), 0.1)])]
    rep = (lambda x: jnp.repeat(x, group, axis=0))
    _, vjp = jax.vjp(lambda q, k, v, *w: j_ref.mlp_softmax_attn(
        q, rep(k), rep(v), *w), *map(jnp.asarray, (q, k, v, *w)))
    want = vjp(jnp.asarray(do))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, *w)]
    msa.reset_bwd_stats()
    got = torch.autograd.grad(msa.mlp_softmax_attn(*ins), ins,
                              torch.from_numpy(do))
    assert msa.bwd_stats() == {"kernel": 0, "ref": 1}
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture
def one_thread():
    """gradcheck's thousands of tiny float64 ops on one torch thread: under
    the suite's parallel workers the full thread pool spins, and each
    case took minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("causal,window,group", [(False, 0, 1), (True, 0, 2),
                                                 (True, 3, 1)])
def test_flash_attn_function_gradcheck(causal, window, group, one_thread):
    g = torch.Generator().manual_seed(1)
    ins = [torch.randn(s, generator=g, dtype=torch.float64)
           .requires_grad_() for s in [(4, 7, 16), (4 // group, 7, 16),
                                       (4 // group, 7, 16)]]
    assert torch.autograd.gradcheck(
        lambda *a: fa.FlashAttn.apply(*a, causal, window), ins)


@pytest.mark.parametrize("group", [1, 2])
def test_mlp_softmax_attn_function_gradcheck(group, one_thread):
    g = torch.Generator().manual_seed(2)
    shapes = [(4, 7, 16), (4 // group, 7, 16), (4 // group, 7, 16), (7, 3),
              (3,), (3, 7), (7,)]
    ins = [(torch.randn(s, generator=g, dtype=torch.float64) * 0.3)
           .requires_grad_() for s in shapes]
    assert torch.autograd.gradcheck(msa.MlpSoftmaxAttn.apply, ins)


def test_port_imports_with_jax_blocked():
    """Every module of src/repro_torch/ imports in a process where jax and
    the JAX package cannot be imported."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
