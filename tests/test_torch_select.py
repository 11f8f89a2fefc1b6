"""The port's selection launcher (`launch/select.py`) against the JAX
package's.

  * `paper_scale_delay` equal to JAX's as floats (the analytic mirror
    scheduled by the same iosched);
  * `run(mode="mpc", ring_bits=32, device="cpu")` at a pool of 80, the
    training steps cut to 3 for time (the card runs the defaults):
    `ledger_agrees`, `n_selected` equal to the budget, and the result's
    keys, its `executed` block's and each phase dict's equal to the JAX
    launcher's (its run is driven with its heavy stages stubbed: only the
    dict's shape is compared, numbers differ because the target is
    random from a torch.Generator);
  * the same run on a real wire (`wire="local"`, `chaos_seed=0`): every
    executed phase's `wire` entry reconciles and recovered its faults;
  * `main()` parses the JAX launcher's flags but `--combine`, `--mesh`
    raises NotImplementedError, every `--protocol` and the wire flags
    (`--wire`, `--net`, `--chaos-seed`, `--chaos-plan`, `--degraded`)
    reach `run()`, and a CPU run prints its report;
  * the phase checkpoints go to a directory of the port's own.
"""
import argparse
import contextlib
import functools

import numpy as np
import jax
import pytest
import torch

from repro.core import iosched as j_iosched, selection as j_sel
from repro.core.executor import PhaseReport as JPhaseReport
from repro.launch import select as j_select
from repro.mpc.comm import Ledger as JLedger
from repro_torch.launch import select

POOL = 80


@pytest.fixture(autouse=True)
def _x64_alias(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.mark.parametrize("n_pool,budget", [(42_000, 0.2), (188_000, 0.1),
                                           (800, 0.3)])
def test_paper_scale_delay_equals_jax(n_pool, budget):
    assert select.paper_scale_delay(n_pool, budget) == \
        j_select.paper_scale_delay(n_pool, budget)


def test_paper_scale_delay_geometry_arguments():
    kw = dict(seq=512, layers=6, d_model=256, heads=4, classes=3, batch=4)
    assert select.paper_scale_delay(10_000, 0.2, **kw) == \
        j_select.paper_scale_delay(10_000, 0.2, **kw)


@pytest.fixture(scope="module")
def jax_shape():
    """The JAX launcher's result for mode="mpc" with its selection,
    finetunes and accuracy stubbed (only the keys are compared), and the
    checkpoint directory it handed run_selection."""
    seen = {}

    def fake_selection(key, params, cfg, pool, sel, **kw):
        seen["ckpt"] = sel.checkpoint_dir
        rep = JPhaseReport(ledger=JLedger(), per_batch=JLedger(),
                           n_batches=1, n_waves=1, wall_s=0.0,
                           sched=j_iosched.SchedConfig())
        n = int(sel.budget_frac * pool.shape[0])
        return j_sel.SelectionResult(np.arange(n), np.arange(2), [], 0.5,
                                     exec_reports=[rep])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mp.setattr(j_select, "run_selection", fake_selection)
        mp.setattr(j_select.tgt, "init_classifier", lambda *a, **k: {})
        mp.setattr(j_select.tgt, "finetune", lambda *a, **k: ({}, 0.0))
        mp.setattr(j_select.tgt, "accuracy", lambda *a, **k: 0.5)
        out = j_select.run(0, n_pool=POOL, mode="mpc", ring_bits=32)
    return out, seen["ckpt"]


@contextlib.contextmanager
def _one_thread():
    """The launcher's small CPU matmuls on one thread: under a loaded
    machine (the suite's parallel workers) torch's thread pool spins and
    the run takes minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp, _one_thread():
        ckpt = str(tmp_path_factory.mktemp("phases"))
        mp.setattr(select, "checkpoint_dir", lambda: ckpt)
        mp.setattr(select, "SelectionConfig", _cut_steps)
        return select.run(0, n_pool=POOL, mode="mpc", ring_bits=32,
                          finetune_steps=3, wave=2, score_batch=16,
                          resume=False, device="cpu")


def test_mpc_run_on_the_cpu(port_run, jax_shape):
    out = port_run
    assert out["executed"]["ledger_agrees"] is True
    assert out["executed"]["resumed_phases"] == 0
    assert len(out["executed"]["phases"]) == 2
    assert out["n_selected"] == int(0.2 * POOL)
    assert 0.0 <= out["acc_ours"] <= 1.0 and 0.0 <= out["acc_random"] <= 1.0
    assert np.isfinite(out["appraisal_entropy"])
    want, _ = jax_shape
    assert set(out) == set(want)
    assert set(out["executed"]) == set(want["executed"])
    assert set(out["executed"]["phases"][0]) == \
        set(want["executed"]["phases"][0])
    assert out["executed"]["phases"][0]["wire"] is None
    assert out["paper_scale_delay"] == want["paper_scale_delay"]


def test_checkpoint_directory_is_the_ports_own(jax_shape):
    _, jax_dir = jax_shape
    assert select.checkpoint_dir() != jax_dir
    assert "selectformer_torch_phases_" in select.checkpoint_dir()


def _jax_parser(monkeypatch):
    """The parser the JAX launcher's main() builds (caught at parse)."""
    caught = {}

    def catch(self, *a, **k):
        caught["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        j_select.main()
    monkeypatch.undo()
    return caught["parser"]


def _flags(parser):
    return {a.option_strings[0]: (a.default, a.choices)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_parser_keeps_the_jax_flags(monkeypatch):
    want = _flags(_jax_parser(monkeypatch))
    got = _flags(select.parser())
    assert "--combine" in want and "--combine" not in got
    del want["--combine"]
    assert got.pop("--device") == ("cuda", None)
    assert got == want


@pytest.mark.parametrize("argv,item", [
    (["--wire", "local"], None),
    (["--wire", "socket", "--chaos-seed", "3"], None),
    (["--wire", "local", "--chaos-seed", "3", "--chaos-plan", "PLAN"], None),
    (["--wire", "local", "--chaos-seed", "3", "--degraded", "--protocol",
      "3pc"], None),
    (["--wire", "socket", "--net", "pod_dcn"], None), (["--net", "ici"], None),
    (["--mesh", "host"], "item 14"), (["--protocol", "3pc"], None),
    (["--protocol", "spdz2pc"], None)])
def test_unported_flags_raise(argv, item, monkeypatch, tmp_path, capsys):
    """Only `--mesh` is refused. The protocol backends (item 11) and the
    wire flags (item 12) pass the refusal check and main() hands them
    on to run(), stubbed here (the whole launcher is not run on the
    CPU): main() prints the wire and chaos lines of a wired run and
    writes each chaotic phase's plan to `--chaos-plan`."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            select.main(argv + ["--device", "cpu", "--mode", "mpc"])
        return
    argv = [str(tmp_path / "plan") if a == "PLAN" else a for a in argv]
    want = vars(select.parser().parse_args(argv))
    seen = {}

    def run(*a, **kw):
        seen.update(kw)
        chaos = kw["chaos_seed"] is not None
        wire = None if kw["wire"] == "none" else {
            "mode": kw["wire"], "wire_makespan_s": 0.5, "bytes_match": True,
            "faults_injected": 4 if chaos else 0, "retries": 2,
            "respawns": 1, "retrans_bytes": 10, "recovery_time_s": 0.25,
            "fault_plan": '{"seed": 3}' if chaos else None}
        return {"executed": {"phases": [{"makespan_wan_s": 1.0,
                                         "device_makespan_s": 0.1,
                                         "wire": wire}],
                             "ledger_agrees": True, "resumed_phases": 0},
                "acc_ours": 0.5, "acc_random": 0.5, "gain": 0.0,
                "paper_scale_delay": {"wan": {
                    "ours_hours": 1.0, "oracle_hours": 2.0,
                    "speedup": 2.0}}}
    monkeypatch.setattr(select, "run", run)
    select.main(argv + ["--device", "cpu", "--mode", "mpc"])
    for k in ("protocol", "wire", "net", "chaos_seed", "degraded"):
        assert seen[k] == want[k], k
    out = capsys.readouterr().out
    assert ("[select] real wire (" in out) == (want["wire"] != "none")
    assert ("[select] chaos: 4 faults" in out) == \
        (want["chaos_seed"] is not None)
    if want["chaos_plan"]:
        path = tmp_path / "plan.phase0.json"
        assert path.read_text() == '{"seed": 3}' and str(path) in out


def test_mpc_run_on_a_real_wire(tmp_path):
    """`run(mode="mpc", ring_bits=32, wire="local", chaos_seed=0)` on the
    CPU: each executed phase replays its tape under faults and
    reconciles (goodput equals the phase's online bytes, digests match,
    a crash recovered), and the ledgers agree."""
    with pytest.MonkeyPatch.context() as mp, _one_thread():
        mp.setattr(select, "checkpoint_dir", lambda: str(tmp_path))
        mp.setattr(select, "SelectionConfig", _cut_steps)
        out = select.run(0, n_pool=POOL, mode="mpc", ring_bits=32,
                         finetune_steps=3, wave=2, score_batch=16,
                         resume=False, wire="local", chaos_seed=0,
                         device="cpu")
    ex = out["executed"]
    assert ex["ledger_agrees"] is True and len(ex["phases"]) == 2
    for ph in ex["phases"]:
        w = ph["wire"]
        assert w["mode"] == "local" and w["bytes_match"] and w["digests_ok"]
        assert w["wire_nbytes"] == w["tape_nbytes"] == ph["nbytes"]
        assert w["faults_injected"] > 0 and w["respawns"] == 1
    assert out["n_selected"] == int(0.2 * POOL)


def test_cuda_without_a_card_raises():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            select.run(0, n_pool=POOL)


def test_main_prints_a_clear_run(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(select, "checkpoint_dir", lambda: str(tmp_path))
    monkeypatch.setattr(select, "SelectionConfig", _cut_steps)
    monkeypatch.setattr(select, "run",
                        functools.partial(select.run, finetune_steps=3))
    with _one_thread():
        select.main(["--pool", "40", "--device", "cpu", "--no-resume"])
    out = capsys.readouterr().out
    assert "[select] ours=" in out and "vs oracle" in out


def _cut_steps(**kw):
    """SelectionConfig with the launcher's step counts cut to 3, for time
    (the final finetunes are cut through `run`'s finetune_steps)."""
    from repro_torch.core.selection import SelectionConfig
    kw.update(exvivo_steps=3, invivo_steps=3, finetune_steps=3)
    return SelectionConfig(**kw)
