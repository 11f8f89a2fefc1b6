"""Proxy model generation + execution (paper §4.2) — the port of
repro/core/proxy.py.

A proxy M̂ = <l, w, d>: l bottom transformer layers of the target with
w heads, FFN removed, and nonlinearities replaced by MLP emulators of
hidden dim d (2l + 1 MLPs total: per-layer MLP_sm + MLP_ln, one MLP_se
on top). The forward exists once, engine-generic, in
`engine/forward.py`.

Generation pipeline (all clear, model-owner side), with the JAX
package's keys and split order:
  1. extract M_g (bottom max(l_i) layers, weights copied)
  2. finetune M_g on the bootstrap sample (`target.finetune`)
  3. collect Gaussian stats of every nonlinear module's inputs
  4. prune depth/width -> proxy skeleton; ex-vivo-train MLPs; insert
  5. in-vivo finetune the proxy end-to-end on bootstrap (CE on logits),
     then refit MLP_se on the updated logits distribution
On the card, step 3's full M_g layers run `flash_attn`, and step 5
differentiates the MLP_sm attention through `mlp_softmax_attn`'s
forward and backward kernels.

Besides: a random-weight proxy for protocol runs, and the model owner's
secret sharing of a proxy.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import approx, target
from repro_torch.core.approx import GaussStats
from repro_torch.core.tree import (adam_step, detached, grads, trainable,
                                   tree_leaves, tree_rebuild)
from repro_torch.engine.clear import ClearEngine
from repro_torch.engine.forward import proxy_logits
from repro_torch.models import common, transformer as T
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RingSpec, RING64
from repro_torch.mpc.sharing import share


@dataclasses.dataclass(frozen=True)
class ProxySpec:
    n_layers: int
    n_heads: int
    mlp_dim: int
    selectivity: float = 1.0     # fraction kept by this phase


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def extract_backbone(params, n_layers: int):
    """M_g: bottom n_layers with all weights copied."""
    out = dict(params)
    out["layers"] = T.layer_slice(params["layers"], slice(0, n_layers))
    return out


@torch.no_grad()
def collect_stats(params, cfg: ArchConfig, tokens, spec: ProxySpec,
                  max_rows: int = 4096):
    """Gaussian <mu, sigma> of each nonlinearity's inputs on M_g."""
    dh = cfg.d_head
    w = spec.n_heads
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device)
    x = emb[tokens].float()
    x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32))
    b, s, d = x.shape
    wk = min(w, cfg.n_kv_heads)
    positions = torch.arange(s, device=x.device)
    sm_stats, ln_stats = [], []
    for li in range(spec.n_layers):
        lp = T.layer_slice(params["layers"], li)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        ln_stats.append(GaussStats.estimate(var.reshape(-1, 1)))
        h = common.apply_norm(x, lp["ln1"], cfg.norm_type)
        ap = lp["attn"]
        q = (h @ ap["wq"][:, :w * dh]).reshape(b, s, w, dh)
        k = (h @ ap["wk"][:, :wk * dh]).reshape(b, s, wk, dh)
        qg = q.reshape(b, s, wk, -1, dh)
        # NOT a proxy forward (that lives solely in engine/forward.py):
        # this probes M_g's attention-score distribution to fit MLP_sm
        scores = torch.einsum("bqkgd,bjkd->bkgqj", qg, k) * dh ** -0.5
        sm_stats.append(GaussStats.estimate(scores.reshape(-1, s)[:max_rows]))
        # advance x through the *full* M_g layer (with FFN) for fidelity
        x, _, _ = T._decoder_layer(x, lp, cfg, mask_kind="bidir",
                                   positions=positions)
    logits = target.classifier_logits(params, cfg, tokens,
                                      n_layers=spec.n_layers)
    se_stats = GaussStats.estimate(logits)
    return {"sm": sm_stats, "ln": ln_stats, "se": se_stats}


def prune(params, cfg: ArchConfig, spec: ProxySpec):
    """Bottom-l layers, first-w heads, FFN dropped."""
    dh = cfg.d_head
    w = spec.n_heads
    wk = min(w, cfg.n_kv_heads)
    layers = T.layer_slice(params["layers"], slice(0, spec.n_layers))
    attn = layers["attn"]
    pruned = {
        "wq": attn["wq"][:, :, :w * dh],
        "wk": attn["wk"][:, :, :wk * dh],
        "wv": attn["wv"][:, :, :wk * dh],
        "wo": attn["wo"][:, :w * dh, :],
    }
    for bname, width in (("bq", w), ("bk", wk), ("bv", wk)):
        if bname in attn:
            pruned[bname] = attn[bname][:, :width * dh]
    ln = layers["ln1"]
    return {"embed": params["embed"], "cls_head": params["cls_head"],
            "attn": pruned,
            "ln_scale": ln["scale"],
            "ln_bias": ln.get("bias", torch.zeros_like(ln["scale"]))}


def build_proxy(key, params_g, cfg: ArchConfig, stats, spec: ProxySpec,
                seq_len: int, n_classes: int, *, exvivo_steps: int = 300):
    """Prune + ex-vivo-train and insert the 2l+1 MLPs (keys split as the
    JAX package splits them: 2i for MLP_sm, 2i + 1 for MLP_ln, the last
    for MLP_se)."""
    pp = prune(params_g, cfg, spec)
    keys = prng.split(key, 2 * spec.n_layers + 1).unbind(-2)
    pp["mlp_sm"] = [approx.fit_softmax_mlp(keys[2 * i], stats["sm"][i],
                                           seq_len, spec.mlp_dim,
                                           steps=exvivo_steps)
                    for i in range(spec.n_layers)]
    pp["mlp_ln"] = [approx.fit_rsqrt_mlp(keys[2 * i + 1], stats["ln"][i],
                                         spec.mlp_dim, steps=exvivo_steps)
                    for i in range(spec.n_layers)]
    pp["mlp_se"] = approx.fit_entropy_mlp(keys[-1], stats["se"], n_classes,
                                          spec.mlp_dim, steps=exvivo_steps)
    return pp


def invivo_finetune(key, pp, cfg: ArchConfig, tokens, labels,
                    spec: ProxySpec, *, steps: int = 150, lr: float = 5e-4,
                    batch: int = 32):
    """Co-tune MLPs + exact weights on bootstrap CE through the clear
    proxy forward (`engine.forward.proxy_logits` on a ClearEngine); refit
    MLP_se after on the tuned logits. Returns a detached proxy."""
    pp = dict(pp)
    mlp_se = pp.pop("mlp_se")
    dev = pp["embed"].device
    key = key.to(dev)
    tokens = torch.as_tensor(tokens, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    tp, leaves = trainable(pp)
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    eng = ClearEngine()
    n = tokens.shape[0]
    for i in range(steps):
        key, k = prng.split(key).unbind(-2)
        idx = prng.randint(k, (min(batch, n),), 0, n)
        logits = proxy_logits(eng, tp, cfg, tokens[idx], spec)
        loss = common.cross_entropy(logits[:, None], labels[idx][:, None])
        adam_step(leaves, grads(loss, leaves), m, v, i, lr)
    pp = detached(tp)
    # refit the entropy head on the tuned proxy's logit distribution
    with torch.no_grad():
        logits = proxy_logits(eng, pp, cfg, tokens, spec)
    stats = GaussStats.estimate(logits)
    key, k = prng.split(key).unbind(-2)
    pp["mlp_se"] = approx.fit_entropy_mlp(k, stats, logits.shape[-1],
                                          mlp_se["w1"].shape[1], steps=300)
    return pp


X_VAR = 1 / 16     # variance of random_proxy's embedded inputs


def random_proxy(gen: torch.Generator, cfg: ArchConfig, spec: ProxySpec,
                 seq_len: int, n_classes: int, device="cuda"):
    """Random-weight proxy, structurally identical to a built one — for
    runs that exercise the *protocol*, where the op stream must be the
    real one but the MLPs need no training.

    Scales keep activations O(1) at any width, so fixed-point scores
    stay inside both rings' headroom (the JAX package's fixed 0.08
    scales do so only at smoke widths — at BERT-base width its
    activations grow by orders of magnitude per layer):
      * embedded inputs have std 1/4 at any width (the engine scales
        the table by sqrt(d_model)), so LayerNorm's sum of d_model
        squares stays well inside RING32's 2f headroom of 128;
      * projections have unit gain (std d_model**-0.5), the output
        projection an eighth of that: near-uniform attention adds the
        same vector to every token, and RING32's 2f headroom (7 integer
        bits) must hold its sum over the sequence when the proxy pools;
      * each MLP_ln interpolates rsqrt(v) piecewise-linearly at `hid`
        knots spread over [v0/4, 4*v0], v0 = 1/16 the variance of the
        embedded input: sum_j a_j relu(t_j - v) + rsqrt(t_hid)
        is convex, positive and decreasing, so LayerNorm still
        normalises;
      * each MLP_sm returns the uniform attention 1/seq plus a random
        perturbation a tenth that size, as a softmax would keep the
        rows' mass.
    """
    device = torch.device(device)
    dh, w = cfg.d_head, spec.n_heads
    wk = min(w, cfg.n_kv_heads)
    L, hid = spec.n_layers, spec.mlp_dim
    proj = cfg.d_model ** -0.5

    def nrm(shape, s):
        return (torch.randn(shape, generator=gen) * s).to(device)

    def mlp_sm():
        p = approx.init_mlp(gen, seq_len, hid, seq_len, device)
        p["w2"] = p["w2"] * (0.1 / seq_len)
        p["b2"] = torch.full((seq_len,), 1.0 / seq_len, device=device)
        return p

    def mlp_ln():
        t = X_VAR * 4.0 ** torch.linspace(-1, 1, hid, dtype=torch.float64)
        f = t.rsqrt()
        a = torch.zeros(hid, dtype=torch.float64)
        if hid > 1:
            m = (f[1:] - f[:-1]) / (t[1:] - t[:-1])   # slope per segment
            a[-1] = -m[-1]
            a[1:-1] = m[1:] - m[:-1]
        return {k: v.to(torch.float32).to(device) for k, v in {
            "w1": -torch.ones((1, hid)), "b1": t, "w2": a[:, None],
            "b2": f[-1:]}.items()}

    return {
        "embed": nrm((cfg.vocab_size, cfg.d_model),
                     (X_VAR / cfg.d_model) ** 0.5),
        "cls_head": nrm((cfg.d_model, n_classes), 0.2),
        "attn": {
            "wq": nrm((L, cfg.d_model, w * dh), proj),
            "wk": nrm((L, cfg.d_model, wk * dh), proj),
            "wv": nrm((L, cfg.d_model, wk * dh), proj),
            "wo": nrm((L, w * dh, cfg.d_model), proj / 8),
        },
        "ln_scale": torch.ones((L, cfg.d_model), device=device),
        "ln_bias": torch.zeros((L, cfg.d_model), device=device),
        "mlp_sm": [mlp_sm() for _ in range(L)],
        "mlp_ln": [mlp_ln() for _ in range(L)],
        "mlp_se": approx.init_mlp(gen, n_classes, hid, 1, device),
    }


def share_proxy(key: torch.Tensor, pp, ring: RingSpec = RING64,
                proto: str = "2pc"):
    """Model owner secret-shares all proxy parameters (one key per
    leaf, split in pytree order as the JAX package does)."""
    leaves = tree_leaves(pp)
    keys = prng.split(key, len(leaves)).unbind(-2)
    return tree_rebuild(pp, [share(k, leaf, ring, proto)
                             for k, leaf in zip(keys, leaves)])
