"""The port's offline schedule search (`core/schedule_search.py`)
against the JAX package's: `schedule_delay` on both rings, eager and
fused, `capacity_score` and `grid_search` at its defaults equal as
floats. The per-phase ledgers are integers (the port's meta probe
against JAX's eval_shape probe) and iosched is the same Python, so the
floats are expected to be exactly equal."""
import jax
import pytest

from repro.core import schedule_search as j_ss
from repro.core.proxy import ProxySpec as JProxySpec
from repro.mpc.comm import POD_DCN as J_POD_DCN
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro_torch.core import schedule_search as ss
from repro_torch.core.proxy import ProxySpec
from repro_torch.mpc.comm import POD_DCN
from repro_torch.mpc.ring import RING32, RING64

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
SCHEDULES = [((3, 12, 16, 1.0),),
             ((1, 1, 2, 0.3), (3, 12, 16, 1.0)),
             ((1, 1, 2, 0.5), (1, 12, 8, 0.5), (3, 12, 16, 1.0))]


@pytest.fixture(autouse=True)
def _x64_alias(monkeypatch):
    """The JAX probe enters RING64's x64 scope through the alias that
    jax 0.9.0 removed (ROADMAP Queue 3)."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _both(sched):
    return (tuple(JProxySpec(*p) for p in sched),
            tuple(ProxySpec(*p) for p in sched))


@pytest.mark.parametrize("fused", [None, False, True])
@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_delay(sched, ring, fused):
    jr, pr = RINGS[ring]
    jp, pp = _both(sched)
    want = j_ss.schedule_delay(jp, 4_000, 800, ring=jr, fused=fused)
    got = ss.schedule_delay(pp, 4_000, 800, ring=pr, fused=fused)
    assert got == want and got > 0


def test_schedule_delay_other_net_and_geometry():
    jp, pp = _both(SCHEDULES[1])
    kw = dict(d_model=256, heads=4, classes=3, seq=64, batch=8)
    assert ss.schedule_delay(pp, 1_000, 100, net=POD_DCN, **kw) == \
        j_ss.schedule_delay(jp, 1_000, 100, net=J_POD_DCN, **kw)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_capacity_score(sched):
    jp, pp = _both(sched)
    for n_pool, budget in ((42_000, 8_400), (800, 160), (10, 9)):
        assert ss.capacity_score(pp, n_pool, budget) == \
            j_ss.capacity_score(jp, n_pool, budget)


def test_grid_search_frontier():
    got = ss.grid_search(42_000)
    want = j_ss.grid_search(42_000)
    assert [(tuple(_spec_tuple(p) for p in s.phases), s.delay_s,
             s.capacity) for s in got] == \
        [(tuple(_spec_tuple(p) for p in s.phases), s.delay_s,
          s.capacity) for s in want]
    assert [s.delay_s for s in got] == sorted(s.delay_s for s in got)


def _spec_tuple(spec):
    return (spec.n_layers, spec.n_heads, spec.mlp_dim, spec.selectivity)
