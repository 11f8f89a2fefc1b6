"""Classifier targets for the paper's experiments — the port of
repro/core/target.py.

The target is a bidirectional encoder (models/transformer.py) with a
mean-pool classification head. Its forward serves the Oracle selection
(score the pool by the target's prediction entropy, keep the top n), the
accuracy readout every efficacy table ends in, and M_g's finetune on the
bootstrap sample (`finetune`, plain Adam). On the card its attention
runs on the `flash_attn` kernel, forward and (in `finetune`) backward,
and its entropy on the `entropy_head` kernel; on the CPU both are plain
torch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import adam_step, detached, grads, trainable
from repro_torch.kernels import ops as kops
from repro_torch.models import common, transformer as T
from repro_torch.mpc import prng


def init_classifier(gen: torch.Generator, cfg: ArchConfig, n_classes: int,
                    device="cuda"):
    """Random classifier parameters with the JAX package's keys, shapes
    and scales, drawn on the generator's device and placed on `device`."""
    params = T.init_params(gen, cfg, device)
    params["cls_head"] = common.dense_init(gen, (cfg.d_model, n_classes),
                                           device=device)
    return params


def encode(params, cfg: ArchConfig, tokens, *, n_layers: int | None = None):
    """Bidirectional encoder features (optionally only bottom n_layers).
    `tokens` (B, S) int, numpy or torch; computed on the params' device."""
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device)
    x = emb[tokens].float()
    x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32))
    positions = torch.arange(x.shape[1], device=x.device)
    layers = params["layers"]
    if n_layers is not None:
        layers = T.layer_slice(layers, slice(0, n_layers))

    def fn(x, lp):
        y, _, aux = T._decoder_layer(x, lp, cfg, mask_kind="bidir",
                                     positions=positions)
        return y, aux
    x, _ = T._scan_uniform(x, layers, fn)
    return common.apply_norm(x, params["final_norm"], cfg.norm_type)


def classifier_logits(params, cfg: ArchConfig, tokens, *,
                      n_layers: int | None = None):
    x = encode(params, cfg, tokens, n_layers=n_layers)
    pooled = x.mean(dim=1)
    return pooled @ params["cls_head"].to(pooled.dtype)


def prediction_entropy(params, cfg: ArchConfig, tokens, **kw):
    """Softmax entropy of the target's prediction, per example — the
    Oracle's score. `kernels.ops.entropy_head` computes m + log z - s/z
    (the JAX package's -sum p log(p + 1e-9) differs by at most
    n_classes * 1e-9 plus rounding)."""
    return kops.entropy_head(classifier_logits(params, cfg, tokens, **kw))


def finetune(key, params, cfg: ArchConfig, tokens, labels, *,
             steps: int = 200, batch: int = 32, lr: float = 1e-3,
             n_layers: int | None = None):
    """Plain Adam finetune of the classifier (clear, model-owner side), on
    the params' device: one `split(key)` a step, batch indices from
    `prng.randint`, cross-entropy of the pooled logits. Returns the
    detached parameters and the last step's loss."""
    dev = params["embed"].device
    key = key.to(dev)
    tokens = torch.as_tensor(tokens, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    p, leaves = trainable(params)
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    n = tokens.shape[0]
    loss = torch.tensor(float("inf"))
    for i in range(steps):
        key, k = prng.split(key).unbind(-2)
        idx = prng.randint(k, (min(batch, n),), 0, n)
        logits = classifier_logits(p, cfg, tokens[idx], n_layers=n_layers)
        loss = common.cross_entropy(logits[:, None], labels[idx][:, None])
        adam_step(leaves, grads(loss, leaves), m, v, i, lr)
    return detached(p), float(loss.detach())


def accuracy(params, cfg: ArchConfig, tokens, labels,
             batch: int = 256) -> float:
    hits = 0
    labels = torch.as_tensor(labels)
    for i in range(0, tokens.shape[0], batch):
        pred = classifier_logits(params, cfg, tokens[i:i + batch]).argmax(-1)
        hits += int((pred.cpu() == labels[i:i + batch]).sum())
    return hits / tokens.shape[0]
