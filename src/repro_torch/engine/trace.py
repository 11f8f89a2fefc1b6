"""TraceEngine — the cost probe.

Runs the MPC op stream of the unified forward on torch's `meta` device
(the counterpart of the JAX package's `jax.eval_shape`): the Python
protocol executes, so every `comm.record` fires with real static shapes,
but no arithmetic runs and no memory is allocated — the kernels' custom
ops answer meta tensors with their fake (shape-only) impls.
`abstract_shares` builds a meta proxy tree, so a BERT-scale per-batch
Ledger costs no weights at all.
"""
import contextlib
import functools

import torch

from repro_torch.engine.forward import proxy_entropy
from repro_torch.engine.mpc import MPCEngine
from repro_torch.mpc import comm, fusion, prng, protocols
from repro_torch.mpc.comm import Ledger
from repro_torch.mpc.ring import RING64, RingSpec
from repro_torch.mpc.sharing import Share

META = torch.device("meta")


class TraceEngine:
    """Probe engine: prices the MPC op stream via `probe()`. It does
    not execute forwards itself."""

    kind = "trace"

    def __init__(self, ring: RingSpec = RING64, variant=None,
                 protocol: str = "2pc"):
        self.ring = ring
        self.variant = variant
        self.protocol = protocol

    def fused(self, label):
        return contextlib.nullcontext()

    def probe(self, pp_sh, cfg, spec, batch_shape, key=None,
              variant=None, fused: bool = False) -> Ledger:
        """Ledger of ONE batch (B, S, d) of the share-level forward.

        `pp_sh` holds meta shares (`abstract_shares`); `fused=True`
        probes the round-compressed stream (the op trace runs under
        `fusion.flight_scope`, exactly as the executor runs it).
        """
        ring, proto = self.ring, self.protocol
        n_parties = protocols.get(proto).n_parties
        variant = self.variant if variant is None else variant
        key = prng.key(0, device=META) if key is None else key.to(META)
        x = torch.empty((n_parties,) + tuple(batch_shape), dtype=ring.dtype,
                        device=META)
        eng = MPCEngine(ring=ring, variant=variant,
                        protocol=proto).with_key(key)
        with comm.ledger_scope() as led:
            with fusion.flight_scope(enabled=fused):
                proxy_entropy(eng, pp_sh, cfg, Share(x, ring, proto), spec,
                              variant)
        return led

    def embed(self, pp, x_in, cfg):
        raise TypeError(
            "TraceEngine measures cost streams abstractly — call "
            "TraceEngine.probe(pp_sh, cfg, spec, batch_shape) instead of "
            "running a forward through it")


@functools.lru_cache(maxsize=256)
def _cached_probe(cfg, spec, seq: int, classes: int, batch: int,
                  ring: RingSpec, protocol: str, fused: bool,
                  variant) -> Ledger:
    pp_sh = abstract_shares(cfg, spec, seq, classes, ring, protocol)
    return TraceEngine(ring, variant, protocol=protocol).probe(
        pp_sh, cfg, spec, (batch, seq, cfg.d_model), fused=fused)


def cached_probe(cfg, spec, *, batch: int, seq: int, classes: int,
                 ring: RingSpec, protocol: str = "2pc",
                 fused: bool = False, variant=None) -> Ledger:
    """Per-batch probe ledger, memoized on the full probe geometry.
    Returns a fresh shallow copy so callers may extend their ledger
    without corrupting the cache."""
    led = _cached_probe(cfg, spec, seq, classes, batch, ring, protocol,
                        fused, variant)
    out = Ledger()
    out.records.extend(led.records)
    return out


def cached_probe_info():
    """lru cache stats for the shared probe memo (hits/misses)."""
    return _cached_probe.cache_info()


def abstract_shares(cfg, spec, seq_len: int, n_classes: int,
                    ring: RingSpec = RING64, protocol: str = "2pc"):
    """Meta-share tree shaped like `proxy.share_proxy`'s output (minus
    the embedding table, which the MPC forward never touches)."""
    dh, w = cfg.d_head, spec.n_heads
    wk = min(w, cfg.n_kv_heads)
    L, hid = spec.n_layers, spec.mlp_dim
    p = protocols.get(protocol).n_parties

    def sh(*shape):
        return Share(torch.empty((p,) + shape, dtype=ring.dtype,
                                 device=META), ring, protocol)

    def mlp(d_in, d_out):
        return {"w1": sh(d_in, hid), "b1": sh(hid),
                "w2": sh(hid, d_out), "b2": sh(d_out)}

    return {
        "cls_head": sh(cfg.d_model, n_classes),
        "attn": {
            "wq": sh(L, cfg.d_model, w * dh),
            "wk": sh(L, cfg.d_model, wk * dh),
            "wv": sh(L, cfg.d_model, wk * dh),
            "wo": sh(L, w * dh, cfg.d_model),
        },
        "ln_scale": sh(L, cfg.d_model),
        "ln_bias": sh(L, cfg.d_model),
        "mlp_sm": [mlp(seq_len, seq_len) for _ in range(L)],
        "mlp_ln": [mlp(1, 1) for _ in range(L)],
        "mlp_se": mlp(n_classes, 1),
    }
