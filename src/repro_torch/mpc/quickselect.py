"""QuickSelect top-k over encrypted scores (paper §4.1).

Finds the *indices* of the k highest entropy values with O(n) expected
pairwise secure comparisons. Each comparison reveals only its binary
outcome (the paper's stated leakage: the rank order information needed
for selection). The data-dependent recursion runs on the host — this is
the selection coordinator, which in deployment drives MPC ops over the
wire; values never leave share form.

Wave coalescing: when the scores were produced by the wave executor the
pool lives in W per-wave batches, so each partition's comparisons are
issued as per-wave `reveal_lt` batches. Those batches compare against
the SAME pivot and are mutually independent, so under `fusion.lat_scope`
they ride ONE comparison flight — the rounds of a partition are paid
once, not once per wave.
"""
from __future__ import annotations

import numpy as np

from repro_torch.mpc.sharing import Share
from repro_torch.mpc import compare, fusion, ops as mops, prng


def _cmp_batch(scores: Share, idx_a: np.ndarray, pivot: int,
               wave: int = 1) -> np.ndarray:
    """Reveal bits [score[i] < score[pivot]] for a batch of indices, in
    ONE message flight (rounds per batch, bytes per element). With
    wave > 1 the batch is issued as per-wave chunks that the flight
    batcher fuses back into a single flight."""
    idx_a = np.asarray(idx_a)
    if wave <= 1 or len(idx_a) <= 1:
        a = scores[idx_a]
        b = scores[np.asarray([pivot] * len(idx_a))]
        return compare.reveal_lt(a, b).cpu().numpy()
    chunks = np.array_split(idx_a, min(wave, len(idx_a)))
    out = []
    with fusion.lat_scope("quickselect"):
        for ch in chunks:
            a = scores[ch]
            b = scores[np.asarray([pivot] * len(ch))]
            out.append(compare.reveal_lt(a, b).cpu().numpy())
    return np.concatenate(out)


def top_k_indices(scores: Share, k: int, seed: int = 0,
                  wave: int = 1) -> np.ndarray:
    """Indices of the k largest encrypted scores.

    `wave` is the executor's wave width: comparisons are issued as
    per-wave batches and coalesced into one flight per partition. The
    selected set is invariant to `wave`.

    Scale-carrying inputs are FORCED to canonical scale up front — one
    truncation for the whole pool — so every `reveal_lt` compares
    canonical encodings.
    """
    if scores.excess != 0:
        scores = mops.force(scores, prng.key(seed ^ 0x5e1ec7,
                                             device=scores.sh.device))
    n = scores.shape[0]
    if k >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    target = k
    out: list[np.ndarray] = []
    # iterative quickselect partitioning on "greater-than-pivot"
    while True:
        if len(idx) == 0:
            break
        if target <= 0:
            break
        if len(idx) <= target:
            out.append(idx)
            break
        pivot_pos = int(rng.integers(len(idx)))
        pivot = int(idx[pivot_pos])
        rest = np.delete(idx, pivot_pos)
        less = _cmp_batch(scores, rest, pivot, wave)  # rest[i] < pivot
        greater = rest[~less]
        smaller = rest[less]
        n_hi = len(greater) + 1                      # pivot included
        if n_hi == target:
            out.append(np.concatenate([greater, [pivot]]))
            break
        if n_hi < target:
            out.append(np.concatenate([greater, [pivot]]))
            target -= n_hi
            idx = smaller
        else:
            idx = greater
    return np.sort(np.concatenate(out)) if out else np.array([], dtype=int)


def expected_comparisons(n: int, k: int) -> float:
    """Analytic expected #comparisons (~2n for k<<n; <=4n worst typical)."""
    return 2.0 * n


def quickselect_cost(n: int, wave: int = 1,
                     coalesce: bool = True) -> tuple[int, int]:
    """(rounds, bytes) for a top-k over n candidates.

    Coalesced (the default, matching `top_k_indices` under the flight
    batcher): O(log n) partition flights, rounds independent of the
    wave chunking. Uncoalesced, every per-wave chunk pays its own
    comparison flight — the eager cost the batcher removes.
    """
    flights = int(np.ceil(np.log2(max(n, 2)))) + 4
    per_partition = 1 if coalesce else max(1, wave)
    return (flights * per_partition * compare.CMP_ROUNDS,
            int(expected_comparisons(n, 0)) * compare.CMP_BYTES)
