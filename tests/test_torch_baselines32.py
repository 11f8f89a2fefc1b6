"""Table 3's baselines (quad_sm: MPCFormer 2Quad; poly_sm: Bolt
polynomial) of the port against the JAX package's, on RING32, through
the checks of test_torch_variants32.VariantParity: the forward eager and
fused bitwise with record-for-record ledgers, the meta probe, decoded
against ClearEngine (printed on RING32) and one `score_phase`."""
from test_torch_variants32 import BASELINES, VariantParity


class TestRing32Baselines(VariantParity):
    RING = "ring32"
    NAMES = BASELINES
