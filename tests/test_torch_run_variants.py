"""`core.executor.run_variants` — Fig 7's four (coalesce, overlap)
schedule points executed on one pool — over MPC on both rings, at
tests/test_engine.py's geometry (d_model 32, 2 heads of 16, proxy
<1, 2, 4>, seq 8, batch 6, 3 classes).

Each point's phase ledger agrees with the makespan model's inputs and
all four score bitwise equal (`run_variants` raises otherwise). The
contract does not depend on the variant, so one exact-op variant runs
on each ring: no-sm, whose exact softmax runs the most share-level
protocols (the tournament max, exp, the reciprocal). That the scores
are the JAX package's is held in test_torch_variants{32,64}.py and
test_torch_baselines{32,64}.py (exact-op variants) and
test_torch_sieve{32,64}.py (full). The proxy is the port's own, random
from a torch.Generator seed: no JAX side."""
import numpy as np
import pytest
import torch

from repro_torch.core import iosched, proxy
from repro_torch.core.executor import run_variants
from repro_torch.engine import VARIANTS
from repro_torch.mpc import prng
from repro_torch.mpc.ring import RING32, RING64
from test_torch_variants32 import BATCH, CFG, CLASSES, GEOM, SEQ, SPEC

RINGS = {"ring32": RING32, "ring64": RING64}


@pytest.fixture(scope="module")
def pp():
    return proxy.random_proxy(torch.Generator().manual_seed(0), CFG, SPEC,
                              SEQ, CLASSES, device="cpu")


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("name", ["no-sm"])
def test_four_schedule_points_agree_and_score_bitwise(pp, name, ring):
    pool = np.random.default_rng(2).integers(0, GEOM["vocab_size"],
                                             (BATCH, SEQ))
    reps = run_variants(prng.key(11), pp, CFG, pool, SPEC, batch=BATCH,
                        wave=1, ring=RINGS[ring], variant=VARIANTS[name],
                        device="cpu")
    assert set(reps) == set(iosched.FIG7_VARIANTS)
    assert all(r.agrees() and r.n_batches == 1 for r in reps.values())


def test_a_changed_score_is_caught(pp, monkeypatch):
    """run_variants compares the points' scores: a schedule that moved a
    share fails it."""
    from repro_torch.core import executor
    calls = []
    real = executor.WaveExecutor.score_phase

    def shifted(self, *a, **kw):
        ent = real(self, *a, **kw)
        calls.append(1)
        return ent.with_sh(ent.sh + (len(calls) == 2))
    monkeypatch.setattr(executor.WaveExecutor, "score_phase", shifted)
    pool = np.zeros((BATCH, SEQ), np.int64)
    with pytest.raises(AssertionError, match="changed scores"):
        run_variants(prng.key(11), pp, CFG, pool, SPEC, batch=BATCH, wave=1,
                     ring=RING32, device="cpu")
