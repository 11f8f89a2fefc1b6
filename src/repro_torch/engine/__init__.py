"""Unified tensor-engine API: one proxy forward, many execution
substrates (clear floats / MPC shares / meta-tensor cost tracing).

    from repro_torch.engine import ClearEngine, MPCEngine, proxy_entropy
    ent = proxy_entropy(ClearEngine(), pp, cfg, tokens, spec)
    ent_sh = proxy_entropy(MPCEngine(ring).with_key(k), pp_sh, cfg,
                           x_shared, spec)
"""
from repro_torch.engine.base import (FULL_VARIANT, VARIANTS, TensorEngine,
                                     resolve_variant)
from repro_torch.engine.clear import ClearEngine
from repro_torch.engine.forward import proxy_entropy, proxy_logits
from repro_torch.engine.mpc import MPCEngine
from repro_torch.engine.trace import (TraceEngine, abstract_shares,
                                      cached_probe, cached_probe_info)

__all__ = ["FULL_VARIANT", "VARIANTS", "TensorEngine", "resolve_variant",
           "ClearEngine", "MPCEngine", "TraceEngine", "abstract_shares",
           "cached_probe", "cached_probe_info", "proxy_entropy",
           "proxy_logits"]
