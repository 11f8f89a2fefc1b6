"""TensorEngine — one proxy forward, many execution substrates.

The proxy layer math exists exactly once (`engine/forward.py`), written
against the `TensorEngine` protocol below, and an engine only interprets
the primitive ops over its own tensor type:

  ClearEngine   float tensors (engine/clear.py)
  MPCEngine     additive shares over a RingSpec, PRNG keys threaded
                internally (engine/mpc.py)
  TraceEngine   the cost probe — runs the MPC op stream on meta tensors
                so every comm.record fires with real shapes but no
                arithmetic runs (engine/trace.py)

Nonlinearity policy: the Table-2/Table-3 `variant` sets are engine-level
strategies. A variant is a frozenset naming which nonlinearities use MLP
emulators ("sm", "ln", "se"); absent members fall back to the exact op,
and "quad_sm" / "poly_sm" select the MPCFormer-2Quad and Bolt-polynomial
softmax baselines. Every variant runs on every engine: over MPC the
exact ops are the share-level protocols of `mpc/nonlinear.py`.
"""
from typing import Any, Protocol, runtime_checkable

Tensor = Any          # opaque: torch tensor (clear) or Share (mpc/trace)

FULL_VARIANT = frozenset({"sm", "ln", "se"})

# Named variant sets: Table 2 ablations + Table 3 baseline nonlinearities.
VARIANTS = {
    "full": FULL_VARIANT,
    "no-sm": frozenset({"ln", "se"}),
    "no-ln": frozenset({"sm", "se"}),
    "no-se": frozenset({"sm", "ln"}),
    "quad_sm": frozenset({"quad_sm", "ln", "se"}),      # MPCFormer 2Quad
    "poly_sm": frozenset({"poly_sm", "ln", "se"}),      # Bolt polynomial
}


@runtime_checkable
class TensorEngine(Protocol):
    """The op vocabulary `engine/forward.py` is written against."""

    kind: str                     # "clear" | "mpc" | "trace"

    def embed(self, pp, x_in, cfg) -> Tensor: ...
    def add(self, x: Tensor, y: Tensor) -> Tensor: ...
    def sub(self, x: Tensor, y: Tensor) -> Tensor: ...
    def mul(self, x: Tensor, y: Tensor) -> Tensor: ...
    def mul_public(self, x: Tensor, v) -> Tensor: ...
    def add_public(self, x: Tensor, v) -> Tensor: ...
    def matmul(self, x: Tensor, y: Tensor) -> Tensor: ...
    def mean(self, x: Tensor, axis: int) -> Tensor: ...
    def fused(self, label: str): ...
    def shape(self, x: Tensor) -> tuple: ...
    def reshape(self, x: Tensor, shape) -> Tensor: ...
    def broadcast(self, x: Tensor, shape) -> Tensor: ...
    def moveaxis(self, x: Tensor, src: int, dst: int) -> Tensor: ...
    def swapaxes(self, x: Tensor, a: int, b: int) -> Tensor: ...
    def index(self, x: Tensor, i: int) -> Tensor: ...
    def mlp(self, p, x: Tensor) -> Tensor: ...
    def ln_inv(self, pp, li: int, var: Tensor, variant) -> Tensor: ...
    def attn_probs(self, pp, li: int, scores: Tensor, variant) -> Tensor: ...
    def attend(self, pp, li: int, qT: Tensor, kT: Tensor, v: Tensor,
               variant) -> Tensor: ...
    def entropy_head(self, pp, logits: Tensor, variant) -> Tensor: ...


def resolve_engine(engine, ring=None, protocol: str = "2pc") -> "TensorEngine":
    """Engine instance from an instance (pass-through) or a mode string
    ("clear" / "mpc" / "trace" — the legacy `SelectionConfig.mode`)."""
    if not isinstance(engine, str):
        return engine
    from repro_torch.engine.clear import ClearEngine
    from repro_torch.engine.mpc import MPCEngine
    from repro_torch.engine.trace import TraceEngine
    from repro_torch.mpc.ring import RING64
    ring = RING64 if ring is None else ring
    if engine == "clear":
        return ClearEngine()
    if engine == "mpc":
        return MPCEngine(ring=ring, protocol=protocol)
    if engine == "trace":
        return TraceEngine(ring=ring, protocol=protocol)
    raise ValueError(f"unknown engine {engine!r} "
                     "(expected 'clear', 'mpc', 'trace', or an instance)")


def resolve_variant(engine, variant) -> frozenset:
    """Per-call variant > engine default > full MLP emulation; strings
    name entries of VARIANTS."""
    if variant is None:
        variant = getattr(engine, "variant", None)
    if variant is None:
        return FULL_VARIANT
    if isinstance(variant, str):
        return VARIANTS[variant]
    return frozenset(variant)
