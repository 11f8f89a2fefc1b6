"""The port's `AppraisalServer` end to end on the CPU, on RING64: the
checks of test_torch_appraisal32.Appraisal (RING64 runs the JAX side
under the `enable_x64` alias, ROADMAP Queue 3)."""
from test_torch_appraisal32 import Appraisal


class TestRing64(Appraisal):
    RING = "ring64"
