"""Table 3's baselines (quad_sm: MPCFormer 2Quad; poly_sm: Bolt
polynomial) of the port against the JAX package's, on RING64, through
the checks of test_torch_variants32.VariantParity; here the decoded
scores are also held to test_engine.py's ATOL against ClearEngine with
the same variant."""
from test_torch_variants32 import BASELINES, VariantParity


class TestRing64Baselines(VariantParity):
    RING = "ring64"
    NAMES = BASELINES
