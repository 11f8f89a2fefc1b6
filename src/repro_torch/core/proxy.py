"""Proxy models (paper §4.2): the serving side.

A proxy M̂ = <l, w, d>: l bottom transformer layers of the target with
w heads, FFN removed, and nonlinearities replaced by MLP emulators of
hidden dim d (2l + 1 MLPs total: per-layer MLP_sm + MLP_ln, one MLP_se
on top). The forward exists once, engine-generic, in
`engine/forward.py`.

This slice ports what scoring a pool with an already-built proxy needs:
the spec, a random-weight proxy, the parameters of a JAX-built proxy
carried across (`core.tree.to_device`), and the model owner's secret
sharing of them. Proxy construction (extraction, pruning, ex-vivo and
in-vivo training) is a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import approx
from repro_torch.core.tree import tree_leaves, tree_rebuild
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RingSpec, RING64
from repro_torch.mpc.sharing import share


@dataclasses.dataclass(frozen=True)
class ProxySpec:
    n_layers: int
    n_heads: int
    mlp_dim: int
    selectivity: float = 1.0     # fraction kept by this phase


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
