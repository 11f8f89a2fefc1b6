"""The port's `run_selection` in mode="mpc" against the JAX package's on
RING64: the checks of test_torch_selection32.SelectionMPC (RING64 runs
the JAX side under the `enable_x64` alias, ROADMAP Queue 3)."""
from test_torch_selection32 import SelectionMPC
from test_torch_selection_clear import jax_proxies, pool, targets

__all__ = ["jax_proxies", "pool", "targets"]   # module fixtures, reused


class TestRing64(SelectionMPC):
    RING = "ring64"
