"""MLP emulators for fused nonlinear operators (paper §4.3) — the port of
repro/core/approx.py.

Each emulator is a 2-layer MLP (Linear -> ReLU -> Linear) substituting a
*group* of nonlinear ops while reducing the dimension the nonlinearity is
evaluated at:

  MLP_sm  softmax over attention scores:   R^S -> R^h -> R^S  (h = 2..16)
  MLP_ln  rsqrt(var + eps) in LayerNorm:   R^1 -> R^h -> R^1
  MLP_se  softmax(logits) + entropy fused: R^C -> R^h -> R^1

Ex-vivo training: estimate Gaussian <mu, sigma> from activations observed
on the finetuned M_g, synthesize inputs from that Gaussian, regress onto
the true operator outputs with plain Adam. Keys, splits and draws are
the JAX package's (`mpc.prng`), so the synthesized inputs equal JAX's up
to `prng.normal`'s last bits. The apply paths live in the engine layer
(`engine/clear.mlp_apply`, `engine/mpc.mlp_apply_mpc`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import adam_step, detached, grads, trainable
from repro_torch.engine.clear import mlp_apply
from repro_torch.kernels import ops as kops
from repro_torch.mpc import prng


def init_mlp(gen: torch.Generator, d_in: int, hidden: int, d_out: int,
             device=None):
    """Random emulator weights (the JAX package's init scales; torch's
    normals, so the values differ from JAX's for the same seed) — what
    `proxy.random_proxy` draws."""
    s1 = (2.0 / (d_in + hidden)) ** 0.5
    s2 = (2.0 / (hidden + d_out)) ** 0.5

    def nrm(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    p = {"w1": nrm(d_in, hidden) * s1,
         "b1": torch.zeros(hidden),
         "w2": nrm(hidden, d_out) * s2,
         "b2": torch.zeros(d_out)}
    return {k: v.to(device) for k, v in p.items()}


def init_mlp_from_key(key: torch.Tensor, d_in: int, hidden: int,
                      d_out: int):
    """The JAX package's `init_mlp(key, ...)`, draw for draw (on the
    key's device): w1 and w2 from `split(key)`'s two keys."""
    k1, k2 = prng.split(key).unbind(-2)
    s1 = (2.0 / (d_in + hidden)) ** 0.5
    s2 = (2.0 / (hidden + d_out)) ** 0.5
    return {"w1": prng.normal(k1, (d_in, hidden)) * s1,
            "b1": torch.zeros(hidden, device=key.device),
            "w2": prng.normal(k2, (hidden, d_out)) * s2,
            "b2": torch.zeros(d_out, device=key.device)}


# ---------------------------------------------------------------------------
# the target operators
# ---------------------------------------------------------------------------

def op_softmax(x):
    return torch.softmax(x, dim=-1)


def op_rsqrt(v, eps: float = 1e-5):
    return torch.rsqrt(v + eps)


def op_softmax_entropy(logits):
    """(N, C) -> (N, 1) softmax entropy, through `kernels.ops.entropy_head`
    (the kernel on the card; its m + log z - s/z differs from the JAX
    package's -sum p log(p + 1e-9) by at most C * 1e-9 plus rounding).
    A regression target: computed without grad."""
    with torch.no_grad():
        return kops.entropy_head(logits)[:, None]


def op_sigmoid(x):
    return torch.sigmoid(x)


# ---------------------------------------------------------------------------
# activation statistics + ex-vivo training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GaussStats:
    mu: torch.Tensor      # per-feature mean
    sigma: torch.Tensor   # per-feature std

    @staticmethod
    def estimate(samples: torch.Tensor) -> "GaussStats":
        flat = samples.detach().reshape(-1, samples.shape[-1]).float()
        return GaussStats(flat.mean(0), flat.std(0, correction=0) + 1e-4)

    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        d = self.mu.shape[-1]
        return self.mu + self.sigma * prng.normal(key, (n, d))


def fit_mlp(key, op_fn, stats: GaussStats, d_in: int, hidden: int,
            d_out: int, *, steps: int = 400, batch: int = 2048,
            lr: float = 3e-3, positive_input: bool = False):
    """Ex-vivo regression of `op_fn` on Gaussian-synthesized inputs, on
    the statistics' device: `kinit, kdata = split(key)`, weights from
    kinit, one `split(kdata)` a step for the batch. Returns a detached
    parameter dict."""
    key = key.to(stats.mu.device)
    kinit, kdata = prng.split(key).unbind(-2)
    p, leaves = trainable(init_mlp_from_key(kinit, d_in, hidden, d_out))
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    for i in range(steps):
        kdata, k = prng.split(kdata).unbind(-2)
        x = stats.sample(k, batch)
        if positive_input:
            x = x.abs() + 1e-4
        y = op_fn(x)
        loss = ((mlp_apply(p, x) - y) ** 2).mean()
        adam_step(leaves, grads(loss, leaves), m, v, i, lr)
    return detached(p)


def fit_softmax_mlp(key, stats: GaussStats, seq: int, hidden: int, **kw):
    return fit_mlp(key, op_softmax, stats, seq, hidden, seq, **kw)


def fit_rsqrt_mlp(key, stats: GaussStats, hidden: int, **kw):
    return fit_mlp(key, op_rsqrt, stats, 1, hidden, 1,
                   positive_input=True, **kw)


def fit_entropy_mlp(key, stats: GaussStats, n_classes: int, hidden: int,
                    **kw):
    return fit_mlp(key, op_softmax_entropy, stats, n_classes, hidden, 1,
                   **kw)


def fit_gate_mlp(key, stats: GaussStats, d: int, hidden: int, **kw):
    """Emulate a sigmoid gate (RG-LRU, MoE routers)."""
    return fit_mlp(key, op_sigmoid, stats, d, hidden, d, **kw)
