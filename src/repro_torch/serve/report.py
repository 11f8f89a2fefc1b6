"""Service-level throughput model + SERVE_report assembly — the port of
repro/serve/report.py.

The perf thesis of the appraisal service: for a long-running server the
metric is SUSTAINED appraisals/hour at a fixed net profile, not any one
run's makespan. Three effects move it, all visible in this report:

  inter-session overlap   one session's compute hides under another's
                          comm — the two-stage pipeline of
                          iosched.makespan lifted from batches to the
                          whole queue: the dominant resource runs
                          continuously, fill is paid ONCE, not per phase
  cross-session cache     fingerprint-identical phases skip execution
  dealer pipelining       offline bytes stream during clear-side work,
                          so online waves never wait (dealer_stall_s)

`serve_makespan` prices the served timeline from the same per-phase
stream totals `iosched` prices standalone runs with — the baseline
(`sequential_makespan`, N independent `run_selection` calls) and the
served number are the same integers scheduled differently, so the
speedup is a statement about scheduling, never about workload drift.
These are modelled times (host arithmetic over the ledgers), not
measured ones.

Every per-phase dict in the report is `PhaseReport.as_dict`.
"""
from __future__ import annotations

from repro_torch.core import iosched
from repro_torch.mpc.comm import NetProfile, PROFILES


def phase_split(rep, net: NetProfile) -> tuple[float, float]:
    """(comm_s, compute_s) of one executed phase's op stream — the two
    pipeline resources the service overlaps across sessions."""
    t = iosched.stream_totals(rep.per_batch, rep.n_batches, rep.sched)
    comm = ((t["lat_rounds"] + t["bw_rounds"]) * net.latency_s
            + t["nbytes"] / net.bandwidth_Bps)
    comp = t["flops"] / rep.sched.flops_per_s
    return comm, comp


def sequential_makespan(all_reports, net: NetProfile) -> float:
    """Baseline: N standalone `run_selection` calls back to back — every
    phase pays its own makespan (within-phase overlap only), cached or
    not (standalone runs execute everything)."""
    return sum(rep.makespan(net) for rep in all_reports)


def serve_makespan(executed_reports, net: NetProfile) -> float:
    """Served timeline: only executed phases cost anything (cache hits
    are free), their comm and compute streams overlap ACROSS sessions,
    and the pipeline fill is paid once for the whole queue."""
    if not executed_reports:
        return 0.0
    comm = comp = 0.0
    fill = 0.0
    for rep in executed_reports:
        c, k = phase_split(rep, net)
        comm += c
        comp += k
        fill = max(fill, rep.makespan(net) - max(c, k))
    return max(comm, comp) + fill


def throughput(sessions, executed_reports, net_name: str = "wan") -> dict:
    """The headline block of SERVE_report.json."""
    net = PROFILES[net_name]
    all_reports = [r for s in sessions for r in s.reports]
    seq_s = sequential_makespan(all_reports, net)
    srv_s = serve_makespan(executed_reports, net)
    n = len(sessions)
    return {
        "net": net_name,
        "n_sessions": n,
        "n_phases_total": len(all_reports),
        "n_phases_executed": len(executed_reports),
        "sequential_makespan_s": seq_s,
        "serve_makespan_s": srv_s,
        "sequential_appraisals_per_hour": (n / (seq_s / 3600)
                                           if seq_s > 0 else 0.0),
        "serve_appraisals_per_hour": (n / (srv_s / 3600)
                                      if srv_s > 0 else 0.0),
        "speedup": (seq_s / srv_s) if srv_s > 0 else float("inf"),
    }
