"""Parallel MPC execution / IO scheduling (paper §4.4).

The paper's observation: after the MLPs project nonlinearities to low
dimensions, the op stream splits into
  bandwidth-bound ops ("bw"): big Beaver matmul openings — cost ~ bytes
  latency-bound ops ("lat"): comparisons & low-dim MLP internals — cost
                             ~ rounds * RTT

Two optimizations:
  1. COALESCING: latency-bound ops from W concurrent batches are stacked
     into one message flight — rounds are paid once per wave, not per
     batch (bytes unchanged).
  2. OVERLAP: while batch i's data is on the wire, batch i+1 computes.
     Makespan -> max(total_comm, total_compute) + pipeline fill, instead
     of their sum.

`makespan` turns a per-batch Ledger into an end-to-end delay under any
NetProfile; the four Fig-7 variants are (coalesce, overlap) in
{False,True}^2.

The schedule is EXECUTABLE, not just priced: core/executor.py runs the
Stage-2 sieve through it (vmapped waves + double-buffered dispatch) and
its recorded flight ledger must reproduce this module's inputs exactly —
`stream_totals` states the contract, `ledger_agrees` checks it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.mpc.comm import Ledger, NetProfile


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    coalesce: bool = True
    overlap: bool = True
    wave: int = 8                 # batches coalesced per flight
    flops_per_s: float = 10e12    # per-party local compute throughput
    memory_batches: int = 8       # max in-flight batches (buffer limit)


def batch_times(led: Ledger, net: NetProfile, sched: SchedConfig):
    """(latency_time, wire_time, compute_time) for ONE batch's ledger."""
    lat_rounds = led.lat_rounds
    bw_rounds = led.bw_rounds
    nbytes = led.nbytes
    compute = led.flops / sched.flops_per_s
    return lat_rounds, bw_rounds, nbytes, compute


def stream_totals(per_batch: Ledger, n_batches: int,
                  sched: SchedConfig) -> dict[str, int]:
    """Integer totals of the op stream the schedule emits for n_batches —
    exactly what `makespan` prices, and exactly what the wave executor's
    phase ledger must add up to (see `ledger_agrees`).

    Coalescing stacks latency-bound flights wave-wide (rounds once per
    wave); bandwidth-bound openings stay one flight per batch; bytes and
    flops are schedule-invariant.
    """
    wave = max(1, sched.wave)            # wave<=0 degenerates to serial
    waves = max(1, -(-n_batches // wave))
    lat_pb = per_batch.lat_rounds
    lat_total = waves * lat_pb if sched.coalesce else n_batches * lat_pb
    return {
        "lat_rounds": lat_total,
        "bw_rounds": n_batches * per_batch.bw_rounds,
        "nbytes": n_batches * per_batch.nbytes,
        "flops": n_batches * per_batch.flops,
        # dealer channel: schedule-invariant like bytes, but streamed
        # ahead of the phase — never an input to makespan
        "offline_nbytes": n_batches * per_batch.offline_nbytes,
    }


def ledger_agrees(stream: Ledger, per_batch: Ledger, n_batches: int,
                  sched: SchedConfig) -> bool:
    """Exact (integer) agreement between a realized executor ledger and
    the makespan model's inputs for the same per-batch op stream."""
    want = stream_totals(per_batch, n_batches, sched)
    return (stream.lat_rounds == want["lat_rounds"]
            and stream.bw_rounds == want["bw_rounds"]
            and stream.nbytes == want["nbytes"]
            and stream.flops == want["flops"]
            and stream.offline_nbytes == want["offline_nbytes"])


def makespan(per_batch: Ledger, n_batches: int, net: NetProfile,
             sched: SchedConfig) -> float:
    """End-to-end delay of n_batches identical batch ledgers."""
    lat_rounds, bw_rounds, nbytes, compute = batch_times(per_batch, net, sched)
    t = stream_totals(per_batch, n_batches, sched)
    latency_total = (t["lat_rounds"] + t["bw_rounds"]) * net.latency_s
    wire_total = t["nbytes"] / net.bandwidth_Bps
    compute_total = n_batches * compute
    if sched.overlap:
        # two-stage pipeline: the dominant resource runs continuously, the
        # other contributes one batch of fill at the pipeline boundary
        comm_total = latency_total + wire_total
        if comm_total >= compute_total:
            return comm_total + compute                # comm-bound
        return compute_total + (lat_rounds + bw_rounds) * net.latency_s \
            + nbytes / net.bandwidth_Bps               # compute-bound
    return latency_total + wire_total + compute_total


# Fig 7's ablation points: variant name -> (coalesce, overlap). The single
# source of truth for both the analytic sweep below and the executed sweep
# (core/executor.run_variants).
FIG7_VARIANTS = {"serial": (False, False), "+coalesce": (True, False),
                 "+overlap": (False, True), "ours": (True, True)}


def fig7_variants(per_batch: Ledger, n_batches: int, net: NetProfile,
                  flops_per_s: float = 10e12) -> dict[str, float]:
    """The paper's ablation points: PMT (no IO sched) vs Ours (full)."""
    return {
        name: makespan(per_batch, n_batches, net,
                       SchedConfig(coalesce=co, overlap=ov,
                                   flops_per_s=flops_per_s))
        for name, (co, ov) in FIG7_VARIANTS.items()
    }
