"""An executed phase of the port's aby3trunc backend (replicated 3PC with
ABY3's exact two-round `trunc2`) against the JAX package's, on RING64:
the checks of test_torch_proto3pc.ProtocolPhase, plus the 2-round
`trunc2` barriers in the eager ledger (their payloads in two
sub-rounds)."""
from test_torch_proto3pc import ProtocolPhase


class TestABY3Trunc(ProtocolPhase):
    PROTO = "aby3trunc"

    def check_ledger(self, led):
        super().check_ledger(led)
        trunc2 = [r for r in led.records if r.op == "trunc2"]
        assert trunc2 and all(r.rounds == 2 * r.wave for r in trunc2)
        assert not [r for r in led.records if r.op == "trunc_reshare"]

    def test_trunc2_payloads_in_two_sub_rounds(self, jax_side):
        """The JAX forward's wire tape (held message for message against
        the port's): each trunc2 flight sends in sub-rounds 0 and 1."""
        got = [{m[3] for m in f[4]} for f in jax_side["eager"][3]
               if f[0] == "trunc2"]
        assert got and all(s == {0, 1} for s in got)
