"""Table 2's ablations (no-sm, no-ln, no-se) of the port against the JAX
package's, on RING64 (the shared checks live in
test_torch_variants32.VariantParity); here the decoded scores are also
held to test_engine.py's ATOL against ClearEngine with the same
variant."""
from test_torch_variants32 import VariantParity


class TestRing64(VariantParity):
    RING = "ring64"
