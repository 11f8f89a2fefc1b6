"""An executed phase of the port's spdz2pc backend (MAC'd malicious 2PC)
against the JAX package's, on RING64: the checks of
test_torch_proto3pc.ProtocolPhase, plus the malicious tier's own.

  * the eager ledger holds the sacrifices, the MAC'd dealer material
    and the boundary MAC check (its key on the offline channel);
  * the forward of one batch under `mac_scope`, eager and not under
    vmap, passes the boundary check with every obligation read; with
    one bit of row 0 flipped at its first partial open it raises
    `MacCheckError` at `MPCEngine.entropy_head`;
  * the serial executor (no vmap) reads every obligation of its
    forwards; the coalesced one (vmap) counts them as unread.
"""
import traceback

import pytest
import torch

from repro_torch.core.executor import ExecConfig, WaveExecutor
from repro_torch.mpc import prng
from repro_torch.mpc.protocols.spdz2pc import (MacCheckError, mac_scope,
                                               tamper_scope)
from repro_torch.mpc.ring import RING64
from test_torch_proto3pc import (BATCH, CFG, KEY, SPEC, WAVE,
                                 ProtocolPhase, _pool)


def flip(sh):
    sh = sh.clone()
    sh.view(sh.shape[0], -1)[0, 0] ^= 1 << 5
    return sh


class TestSPDZ2PC(ProtocolPhase):
    PROTO = "spdz2pc"

    def check_ledger(self, led):
        ops = {r.op for r in led.records}
        assert {"sacrifice", "mac_check", "offline.mac_key",
                "offline.sacrifice_triple",
                "offline.sacrifice_matmul_triple"} <= ops
        assert led.offline_nbytes > 0

    def test_honest_forward_passes_the_boundary_check(self, pp):
        with mac_scope() as st:
            ent, _ = self._forward(pp)         # entropy_head verifies
            assert st.n_opened > 0 and st.n_traced == 0
            assert st.flags == []
        assert ent.sh.shape[0] == 4

    def test_tampered_forward_aborts_at_entropy_head(self, pp):
        with mac_scope():
            with tamper_scope(flip):
                with pytest.raises(MacCheckError, match="aborting") as e:
                    self._forward(pp)
        names = [f.name for f in traceback.extract_tb(e.value.__traceback__)]
        assert "entropy_head" in names and "mac_check_flight" in names

    @pytest.mark.parametrize("coalesce", [False, True])
    def test_executor_obligations(self, pp, coalesce):
        with mac_scope() as st:
            ex = WaveExecutor(ExecConfig(wave=WAVE, batch=BATCH, ring=RING64,
                                         protocol=self.PROTO,
                                         coalesce=coalesce, device="cpu"))
            ex.score_phase(prng.key(KEY), pp, CFG, _pool()[:BATCH], SPEC)
        assert st.n_opened > 0 and st.flags == []
        assert st.n_traced == (st.n_opened if coalesce else 0)
