"""`models.transformer.train_loss` of the port against the JAX package's
on the CPU, for one architecture of each family (dense, moe, vlm, encdec,
ssm, hybrid) at its smoke config in float32: the loss within 1e-5 of
|JAX| and each gradient leaf within 1e-4 of that leaf's max |JAX|,
against `jax.value_and_grad(train_loss)`. JAX's weights are built once a
module (`zoo_parity.jax_weights`) and carried across; the batch (tokens,
labels with the last of each row -1, the stub patches / frames) comes
from numpy. On the CPU the port's forward takes the plain attention, and
its SSD and RG-LRU scans go through their autograd Functions with the
plain backward versions (`ref.ssd_bwd`, `ref.rg_lru_bwd`); JAX
differentiates its plain jnp forward. Remat (activation checkpointing)
is held bitwise: the gradients with and without it are equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import transformer as j_T
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as T
from zoo_parity import batch_for, jax_batch, jax_weights, leaves

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
FAMILIES = {"dense": "qwen2_0_5b", "moe": "granite_moe_3b",
            "vlm": "paligemma_3b", "encdec": "whisper_small",
            "ssm": "mamba2_2_7b", "hybrid": "recurrentgemma_2b"}


@functools.cache
def j_value_and_grad():
    return jax.jit(jax.value_and_grad(j_T.train_loss, has_aux=True),
                   static_argnums=(1,))


def lm_batch(cfg, seed=3):
    batch = batch_for(cfg, seed)
    labels = np.roll(batch["tokens"], -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return {**batch, "tokens": batch["tokens"].astype(np.int32),
            "labels": labels}


def port_grads(p, cfg, batch, remat):
    """(loss, aux, {path: grad}) of the port's train_loss."""
    p, ls = tree.trainable(p)
    loss, aux = T.train_loss(p, cfg, batch, remat=remat)
    g = tree.grads(loss, ls)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            leaves(tree.tree_rebuild(p, list(g))))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The smoke models' small CPU products on two threads: under the
    suite's parallel workers torch's full thread pool spins and the
    module takes minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return request.param


@pytest.fixture(scope="module")
def both(family):
    """The port's and JAX's loss, aux and gradients at float32."""
    arch = FAMILIES[family]
    j_cfg = dataclasses.replace(j_base.load_arch(arch, smoke=True),
                                dtype="float32")
    cfg = dataclasses.replace(base.load_arch(arch, smoke=True),
                              dtype="float32")
    jp, p = jax_weights(arch)
    batch = lm_batch(cfg)
    (j_loss, j_aux), j_g = j_value_and_grad()(jp, j_cfg, jax_batch(batch))
    kops.reset_ssd_bwd_stats()
    kops.reset_lru_bwd_stats()
    ours = port_grads(p, cfg, batch, remat=True)
    calls = {"ssd": kops.ssd_bwd_stats(), "lru": kops.lru_bwd_stats()}
    return cfg, p, batch, ours, (j_loss, j_aux,
                                 leaves(jax.tree.map(np.asarray, j_g))), calls


def test_train_loss_matches_jax(both):
    cfg, _, _, (loss, aux, _), (j_loss, j_aux, _), _ = both
    w = float(j_loss)
    assert np.isfinite(w) and abs(float(loss) - w) <= LOSS_TOL * abs(w)
    assert set(aux) == set(j_aux)
    for k in aux:
        assert abs(float(aux[k]) - float(j_aux[k])) \
            <= GRAD_TOL * abs(float(j_aux[k])), k


def test_train_loss_gradients_match_jax(both):
    cfg, _, _, (_, _, g), (_, _, j_g), calls = both
    assert set(g) == set(j_g)
    for path, x in g.items():
        want = np.asarray(j_g[path], dtype=np.float32)
        got = x.numpy()
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()) + 1e-30, \
            (path, err, float(np.abs(want).max()))
    # the scans' backwards ran through their Functions' plain versions
    if cfg.family == "ssm":
        assert calls["ssd"]["ref"] == cfg.n_layers
    if cfg.family == "hybrid":
        assert calls["lru"]["ref"] == cfg._layer_kinds().count("rec")


def test_remat_gradients_are_bitwise_equal(both):
    """Checkpointed layers recompute the same forward: the loss and every
    gradient equal those without remat, bit for bit."""
    cfg, p, batch, (loss, _, g), _, _ = both
    loss2, _, g2 = port_grads(p, cfg, batch, remat=False)
    assert torch.equal(loss, loss2)
    for path in g:
        assert torch.equal(g[path], g2[path]), path
