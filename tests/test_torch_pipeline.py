"""The port's LM data pipeline (`data/pipeline.py`, a numpy copy of the
JAX package's) against the JAX package's on the CPU: `synth_lm_batch`
bitwise over several (seed, step, host), and `DataPipeline`'s resume
exactly once (a pipeline restarted at a saved step yields the batches
that follow it, none repeated and none skipped)."""
import numpy as np
import pytest

from repro.data import pipeline as j_pipe
from repro_torch.data import pipeline as pipe


@pytest.mark.parametrize("seed,step,host,n_hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 0, 1, 2), (3, 41, 1, 4),
    (12345, 1000, 3, 4)])
def test_synth_lm_batch_is_bitwise_jax(seed, step, host, n_hosts):
    got = pipe.synth_lm_batch(seed, step, host, n_hosts, 8, 33, 151936)
    want = j_pipe.synth_lm_batch(seed, step, host, n_hosts, 8, 33, 151936)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k]), k
    assert (got["labels"][:, -1] == -1).all()
    assert np.array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_pipeline_matches_jax_and_resumes_exactly_once():
    ours = pipe.DataPipeline(5, 4, 16, 1000, prefetch=3)
    theirs = j_pipe.DataPipeline(5, 4, 16, 1000, prefetch=3)
    try:
        first = [next(ours) for _ in range(5)]
        for b in first:
            w = next(theirs)
            assert all(np.array_equal(b[k], w[k]) for k in b)
        state = ours.state()
        assert (state.seed, state.step) == (5, 5)
    finally:
        ours.close()
        theirs.close()
    resumed = pipe.DataPipeline(state.seed, 4, 16, 1000,
                                start_step=state.step)
    try:
        after = [next(resumed) for _ in range(3)]
    finally:
        resumed.close()
    for i, b in enumerate(after):
        want = pipe.synth_lm_batch(5, 5 + i, 0, 1, 4, 16, 1000)
        assert all(np.array_equal(b[k], want[k]) for k in b)
    seen = {b["tokens"].tobytes() for b in first + after}
    assert len(seen) == 8
