"""The port's fault-tolerance runtime (`repro_torch.runtime.ft`) against
the JAX package's `repro.runtime.ft`, under injected clocks:

  * `plan_remesh` gives JAX's ElasticPlan (moves, fraction, bytes);
  * `HeartbeatMonitor` and `StragglerMitigator` give JAX's suspects,
    deadlines and backup firings for the same clock sequence;
  * `retry` sleeps JAX's backoff sequence, with and without a deadline,
    and raises the last error after its attempts;
  * `TransportHeartbeat` carries beats as BEAT frames over the port's
    LocalTransport into a monitor, counting no DATA bytes.
"""
import dataclasses

import pytest

from repro.runtime import ft as j_ft
from repro_torch import runtime
from repro_torch.net import transport as tp
from repro_torch.runtime import ft


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_package_exports_jax_names():
    import repro.runtime as j_runtime
    names = ("HeartbeatMonitor", "StragglerMitigator", "retry",
             "ElasticPlan", "plan_remesh")
    for name in names:
        assert hasattr(runtime, name) and hasattr(j_runtime, name)


@pytest.mark.parametrize("old,new,bph", [
    ((4, 2), (2, 2), 1), ((8,), (6,), 1_000), ((2, 2, 2), (3, 4), 77),
    ((1,), (5,), 10), ((16, 16), (8, 16), 1 << 20), ((3,), (3,), 9)])
def test_plan_remesh_equals_jax(old, new, bph):
    got = ft.plan_remesh(old, new, bytes_per_host=bph)
    want = j_ft.plan_remesh(old, new, bytes_per_host=bph)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got, ft.ElasticPlan)


def _heartbeats(mod):
    clk = FakeClock()
    mon = mod.HeartbeatMonitor(4, timeout_s=5.0, clock=clk)
    seen = []
    for step in range(8):
        clk.t = step * 2.0
        for h in range(4):
            if h < 4 - step // 2:          # hosts fall silent in turn
                mon.beat(h)
        seen.append((mon.suspects(), mon.healthy()))
    return seen


def test_heartbeat_monitor_equals_jax():
    got = _heartbeats(ft)
    assert got == _heartbeats(j_ft)
    assert got[0] == ([], True) and got[-1][0] == [2, 3]


def _stragglers(mod):
    clk = FakeClock()
    sm = mod.StragglerMitigator(slack=2.0, window=16, clock=clk)
    out = []
    for i, dt in enumerate([1.0] * 9 + [0.5, 3.0, 1.5, 10.0, 1.0, 4.5]):
        def task(dt=dt):
            clk.t += dt
            return ("task", i)
        out.append((sm.deadline(), sm.run(task, backup=lambda: "backup")))
    return out, sm.backups_fired


def test_straggler_mitigator_equals_jax():
    got = _stragglers(ft)
    assert got == _stragglers(j_ft)
    out, fired = got
    assert out[0][0] == float("inf") and fired >= 2


@pytest.mark.parametrize("kw", [{}, {"attempts": 6, "backoff_s": 0.5},
                                {"attempts": 10, "backoff_s": 1.0,
                                 "deadline_s": 9.0},
                                {"attempts": 12, "backoff_s": 0.02,
                                 "max_backoff_s": 0.25}])
def test_retry_backoff_equals_jax(kw):
    def run(mod, succeed_on):
        clk, slept, calls = FakeClock(), [], []

        def sleep(dt):
            slept.append(dt)
            clk.t += dt

        def fn():
            calls.append(clk.t)
            if len(calls) == succeed_on:
                return "done"
            raise OSError(f"attempt {len(calls)}")
        try:
            res = mod.retry(fn, sleep=sleep, clock=clk, **kw)
        except OSError as e:
            res = f"raised {e}"
        return res, slept, calls
    for succeed_on in (1, 3, 100):
        assert run(ft, succeed_on) == run(j_ft, succeed_on)
    res, slept, _ = run(ft, 100)
    assert res.startswith("raised")


def test_retry_passes_other_errors_through():
    def fn():
        raise KeyError("not retriable")
    with pytest.raises(KeyError):
        ft.retry(fn, sleep=lambda dt: pytest.fail("slept"))


def test_transport_heartbeat_over_the_ports_transport():
    t = tp.LocalTransport(3)
    clk = FakeClock()
    mon = ft.HeartbeatMonitor(3, timeout_s=5.0, clock=clk)
    hb0 = ft.TransportHeartbeat(t, 0, 3, monitor=mon, kind=tp.BEAT)
    hb1 = ft.TransportHeartbeat(t, 1, 3, kind=tp.BEAT)
    hb2 = ft.TransportHeartbeat(t, 2, 3, kind=tp.BEAT)
    for step in range(4):
        clk.t = step * 3.0
        hb1.emit()
        if step == 0:
            hb2.emit()                 # party 2 falls silent
        hb0.drain()
    assert mon.suspects() == [2] and not mon.healthy()
    assert hb0.beats_seen == 5 and t.total_data_bytes == 0
    assert hb1.drain() == 0            # no monitor: drains nothing
