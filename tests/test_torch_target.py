"""The port's target classifier against the JAX package's, on the CPU:
`models/common`, `models/attention`, `models/ffn`, the dense
`models/transformer` subset and `core/target`'s forward, plus the copied
`data/tasks`.

Small geometry: 2 layers, d_model 64, 4 heads of 16, d_ff 128, vocab
256, seq 32. Weights are built by the JAX package from a seed and
carried across with `core.tree.to_device`; other inputs come from numpy.
Everything is float32. Tolerances: 1e-5 (absolute and relative) for
every float comparison, 1e-6 for the elementwise activations; `accuracy`
equal, with predictions compared where the top-2 logit margin exceeds
1e-4. The target's entropy is held against the JAX package's
`prediction_entropy` (-sum p log(p + 1e-9)); the port computes
m + log z - s/z (`kernels.ops.entropy_head`), within n_classes * 1e-9.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.paper_targets import TINY_TARGET as J_TINY
from repro.core import target as j_target
from repro.data import tasks as j_tasks
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import transformer as j_T
from repro_torch.configs.paper_targets import TINY_TARGET
from repro_torch.core import target, tree
from repro_torch.data import tasks
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, common, ffn, transformer as T

GEOM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
            d_ff=128, vocab_size=256)
J_CFG = dataclasses.replace(J_TINY, **GEOM)
CFG = dataclasses.replace(TINY_TARGET, **GEOM)
SEQ, CLASSES = 32, 4
TOL = dict(atol=1e-5, rtol=1e-5)


def rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def leaves_with_paths(tree_):
    out = {}

    def go(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                go(v, path + (k,))
        else:
            out[path] = tuple(x.shape)
    go(tree_, ())
    return out


@pytest.fixture(scope="module")
def jparams():
    return j_target.init_classifier(jax.random.key(0), J_CFG, CLASSES)


@pytest.fixture(scope="module")
def params(jparams):
    return tree.to_device(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def task():
    return tasks.make_classification_task(3, n_pool=48, n_test=48, seq=SEQ,
                                          vocab=256, n_classes=CLASSES)


# ---------------------------------------------------------------------------
# models/common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "relu", "silu"])
def test_activations_match_jax(name):
    """"gelu" is the tanh approximation: jax.nn.gelu's default."""
    x = rand(1, (4, 64), 3.0)
    close(common.act_fn(name)(t(x)), j_common.act_fn(name)(jnp.asarray(x)),
          atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_interleaved_pairs_match_jax(fraction):
    x = rand(2, (2, 12, 3, 16))
    pos = np.arange(12)[None].repeat(2, 0) + np.array([[0], [5]])
    got = common.apply_rope(t(x), t(pos), 1e4, fraction)
    want = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction)
    close(got, want)


def test_norms_match_jax():
    x, g, b = rand(3, (4, 8, 64), 2.0), rand(4, (64,)), rand(5, (64,))
    close(common.layernorm(t(x), t(g), t(b)),
          j_common.layernorm(*map(jnp.asarray, (x, g, b))))
    close(common.rmsnorm(t(x), t(g)),
          j_common.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    for kind in ("layernorm", "rmsnorm"):
        p = common.init_norm(64, kind)
        jp = j_common.init_norm(64, kind)
        assert p.keys() == jp.keys()
        close(common.apply_norm(t(x), p, kind),
              j_common.apply_norm(jnp.asarray(x), jp, kind))


def test_cross_entropy_matches_jax():
    logits = rand(6, (3, 5, 11), 2.0)
    labels = np.random.default_rng(7).integers(0, 11, (3, 5))
    labels[0, :2] = -1                                 # ignored
    close(common.cross_entropy(t(logits), t(labels)),
          j_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("kind", ["causal", "local", "bidir", "prefix"])
def test_masks_match_jax(kind):
    qp, kp = np.arange(10)[:, None], np.arange(10)[None, :]
    got = common.mask_fn(kind, window=3, prefix_len=4)(t(qp), t(kp))
    want = j_common.mask_fn(kind, window=3, prefix_len=4)(jnp.asarray(qp),
                                                         jnp.asarray(kp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_truncated_normal_init():
    gen = torch.Generator().manual_seed(0)
    w = common.dense_init(gen, (256, 512))
    assert float(w.abs().max()) <= 2 / 16
    assert abs(float(w.std()) * 16 - 0.8796) < 0.01   # std of N(0,1) on [-2,2]


# ---------------------------------------------------------------------------
# models/attention and ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_kv", [4, 2])
@pytest.mark.parametrize("kind", ["causal", "bidir", "local", "prefix"])
def test_attend_full_matches_jax(kind, n_kv):
    q, k, v = rand(8, (2, 16, 4, 16)), rand(9, (2, 16, n_kv, 16)), \
        rand(10, (2, 16, n_kv, 16))
    kw = dict(mask_kind=kind, window=5, prefix_len=3)
    close(attention.attend_full(t(q), t(k), t(v), **kw),
          j_attention.attend_full(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("kind", ["causal", "bidir", "local"])
def test_attend_chunked_matches_jax(kind):
    q, k, v = rand(11, (2, 32, 4, 16)), rand(12, (2, 32, 2, 16)), \
        rand(13, (2, 32, 2, 16))
    kw = dict(mask_kind=kind, window=8, q_chunk=8, kv_chunk=16)
    close(attention.attend_chunked(t(q), t(k), t(v), **kw),
          j_attention.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("n_kv", [4, 2])
@pytest.mark.parametrize("kind", ["causal", "bidir"])
def test_attend_flash_front_matches_attend_full(kind, n_kv):
    """The card's path (heads folded into the kernel's batch, kv per
    group) on the CPU, where the front takes the plain flash_attn."""
    q, k, v = rand(14, (2, 24, 4, 16)), rand(15, (2, 24, n_kv, 16)), \
        rand(16, (2, 24, n_kv, 16))
    close(attention.attend_flash(t(q), t(k), t(v), mask_kind=kind),
          attention.attend_full(t(q), t(k), t(v), mask_kind=kind))


def test_attend_flash_refuses_other_masks():
    """bidir, causal, local (the causal window) and prefix have a kernel
    form; any other mask kind raises."""
    q = t(rand(0, (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="mask"):
        attention.attend_flash(q, q, q, mask_kind="sliding")
    assert attention.attend_flash(q, q, q, mask_kind="prefix",
                                  prefix_len=2).shape == q.shape


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_dense_ffn_matches_jax(act):
    jp = j_ffn.init_dense_ffn(jax.random.key(1), 64, 128, act, 1)
    jp = jax.tree.map(lambda a: a[0], jp)
    x = rand(17, (2, 8, 64))
    close(ffn.dense_ffn(t(x), tree.to_device(jax.tree.map(np.asarray, jp),
                                             "cpu"), act),
          j_ffn.dense_ffn(jnp.asarray(x), jp, act))


# ---------------------------------------------------------------------------
# models/transformer and core/target
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qkv_bias", [False, True])
def test_init_classifier_keys_and_shapes_match_jax(qkv_bias):
    jcfg = dataclasses.replace(J_CFG, qkv_bias=qkv_bias)
    cfg = dataclasses.replace(CFG, qkv_bias=qkv_bias)
    want = leaves_with_paths(jax.eval_shape(
        lambda k: j_target.init_classifier(k, jcfg, CLASSES),
        jax.random.key(0)))
    got = leaves_with_paths(target.init_classifier(
        torch.Generator().manual_seed(0), cfg, CLASSES, device="cpu"))
    assert got == want


@pytest.mark.parametrize("n_kv", [4, 2])
def test_decoder_layer_matches_jax(n_kv):
    jcfg = dataclasses.replace(J_CFG, n_kv_heads=n_kv)
    cfg = dataclasses.replace(CFG, n_kv_heads=n_kv)
    jp = j_T.init_params(jax.random.key(2), jcfg)["layers"]
    jlp = jax.tree.map(lambda a: a[0], jp)
    lp = tree.to_device(jax.tree.map(np.asarray, jlp), "cpu")
    x = rand(18, (2, SEQ, 64))
    pos = np.arange(SEQ)
    for kind in ("bidir", "causal"):
        got, _, _ = T._decoder_layer(t(x), lp, cfg, mask_kind=kind,
                                     positions=t(pos))
        want, _, _ = j_T._decoder_layer(jnp.asarray(x), jlp, jcfg,
                                        mask_kind=kind,
                                        positions=jnp.asarray(pos))
        close(got, want)


@pytest.mark.parametrize("n_layers", [None, 1])
def test_classifier_logits_match_jax(params, jparams, task, n_layers):
    tok = task.pool_tokens[:8]
    close(target.classifier_logits(params, CFG, tok, n_layers=n_layers),
          j_target.classifier_logits(jparams, J_CFG, jnp.asarray(tok),
                                     n_layers=n_layers))


def test_prediction_entropy_matches_jax(params, jparams, task):
    tok = task.pool_tokens[:16]
    kops.reset_eh_stats()
    got = target.prediction_entropy(params, CFG, tok)
    assert kops.eh_stats() == {"kernel": 0, "ref": 1}
    close(got, j_target.prediction_entropy(jparams, J_CFG, jnp.asarray(tok)))


def test_accuracy_matches_jax(params, jparams, task):
    tok, lab = task.test_tokens, task.test_labels
    logits = target.classifier_logits(params, CFG, tok).numpy()
    jlogits = np.asarray(j_target.classifier_logits(jparams, J_CFG,
                                                    jnp.asarray(tok)))
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(logits.argmax(-1)[sure],
                                  jlogits.argmax(-1)[sure])
    got = target.accuracy(params, CFG, tok, lab, batch=20)
    want = j_target.accuracy(jparams, J_CFG, jnp.asarray(tok),
                             jnp.asarray(lab))
    assert abs(got - want) <= float((~sure).mean())
    if sure.all():
        assert got == want


def test_target_attention_runs_the_flash_front(params, task, monkeypatch):
    """On the CPU the encoder takes the plain attend_full; attend_flash
    (the card's branch) gives the same logits when forced."""
    tok = task.pool_tokens[:4]
    want = target.classifier_logits(params, CFG, tok)
    monkeypatch.setattr(attention, "attend_full",
                        lambda q, k, v, mask_kind, **kw:
                        attention.attend_flash(q, k, v, mask_kind=mask_kind))
    kops.reset_fa_stats()
    got = target.classifier_logits(params, CFG, tok)
    assert kops.fa_stats()["ref"] == CFG.n_layers
    close(got, want)


# ---------------------------------------------------------------------------
# data/tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [(0, {}), (5, dict(n_pool=64, n_test=16,
                                                       seq=512, vocab=30522,
                                                       n_classes=2))])
def test_tasks_equal_jax_package(seed, kw):
    a = tasks.make_classification_task(seed, **kw)
    b = j_tasks.make_classification_task(seed, **kw)
    for f in ("pool_tokens", "pool_labels", "test_tokens", "test_labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_classes, a.vocab) == (b.n_classes, b.vocab)
