"""The 3-stage private selection workflow (paper §4.1) — the port of
repro/core/selection.py.

Stage 1 (clear): purchase the bootstrap sample S_boot.
Stage 2 (MPC):   N-phase progressive sieve. Phase i scores surviving
                 candidates with proxy M̂_i (encrypted entropy) and keeps
                 the top alpha_i fraction via QuickSelect over secure
                 comparisons (only comparison bits revealed).
Stage 3 (clear): transaction; optional appraisal = mean entropy of S_N.

`selection_plan` is the pipeline as a generator with the JAX package's
PRNG split order; `run_selection` drives it with one `WaveExecutor` a
phase. `mode="clear"` scores each phase with the float proxy on a
`ClearEngine` (on the card: `mlp_softmax_attn`), `mode="mpc"` through
the wave executor over shares. The clear-side training that builds the
proxies (`target.finetune`, `proxy.build_proxy`, `invivo_finetune`)
runs on the target parameters' device, and the executor's
(`ExecConfig.device`) must be the same. The reference's 64-bit scope
around QuickSelect has no counterpart: torch's int64 is native.

Phase boundaries checkpoint the surviving index set (JSON, replaced
atomically); a re-run with the same fingerprint resumes after the last
completed phase.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import proxy as proxy_mod, target as target_mod
from repro_torch.core.executor import ExecConfig, PhaseReport, WaveExecutor
from repro_torch.core.proxy import ProxySpec
from repro_torch.core.tree import tree_leaves
from repro_torch.engine.base import (FULL_VARIANT, TensorEngine,
                                     resolve_engine)
from repro_torch.engine.forward import proxy_entropy
from repro_torch.mpc import prng, quickselect
from repro_torch.mpc.sharing import Share, reconstruct


@dataclasses.dataclass
class SelectionConfig:
    phases: list[ProxySpec]
    budget_frac: float = 0.20         # B / |D|
    boot_frac: float = 0.05           # bootstrap share of the pool
    score_batch: int = 64
    exvivo_steps: int = 300
    invivo_steps: int = 150
    finetune_steps: int = 200
    mode: str = "clear"               # legacy: "clear" | "mpc"
    engine: TensorEngine | str | None = None   # preferred over `mode`
    checkpoint_dir: str | None = None
    resume: bool = True               # consult phase checkpoints on start
    variant: frozenset = FULL_VARIANT  # Table 2/3 ablations
    # the MPC engine runs through the wave executor; (wave, coalesce,
    # overlap) are the §4.4 schedule
    executor: ExecConfig = dataclasses.field(default_factory=ExecConfig)

    def __post_init__(self):
        self.engine = resolve_engine(self.engine if self.engine is not None
                                     else self.mode, ring=self.executor.ring,
                                     protocol=self.executor.protocol)
        self.mode = self.engine.kind
        if self.mode == "mpc":
            # the executor must run the engine's exact substrate
            if self.executor.ring is not self.engine.ring or \
                    self.executor.protocol != self.engine.protocol:
                self.executor = dataclasses.replace(
                    self.executor, ring=self.engine.ring,
                    protocol=self.engine.protocol)


@dataclasses.dataclass
class SelectionResult:
    selected: np.ndarray              # indices into the pool
    boot_idx: np.ndarray
    phase_survivors: list[np.ndarray]
    appraisal_entropy: float
    exec_reports: list[PhaseReport] = dataclasses.field(default_factory=list)
    resumed_phases: int = 0           # phases restored from checkpoints
    # raw per-phase score shares (MPC mode) — the bitwise-parity witness
    phase_scores: list[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PhaseRequest:
    """One sieve phase's executable work order, yielded by
    `selection_plan`: score `tokens` with proxy `pp` under `spec`, send
    the entropy Share (plus the executor's PhaseReports) back in."""
    phase: int
    key: torch.Tensor                 # the per-phase ks split
    pp: dict                          # proxy params (model-owner side)
    tokens: np.ndarray                # surviving candidates' tokens
    spec: ProxySpec
    keep: int                         # survivors after QuickSelect
    batch: int                        # executor batch for this phase
    fingerprint: str | None           # run fingerprint (checkpoint key)


def two_phase_default(seq_len_heads: int = 12) -> list[ProxySpec]:
    """The paper's main schedule: <1 layer, 1 head, d=2> -> <3, all, 16>."""
    return [ProxySpec(1, 1, 2, selectivity=0.5),
            ProxySpec(3, seq_len_heads, 16, selectivity=1.0)]


def _phase_keep(n_pool: int, budget: int, phases: list[ProxySpec]) -> list[int]:
    """Survivor counts per phase ending exactly at the budget."""
    keeps = []
    cur = n_pool
    for i, ph in enumerate(phases):
        if i == len(phases) - 1:
            keeps.append(budget)
        else:
            cur = max(budget, int(round(cur * ph.selectivity)))
            keeps.append(cur)
    return keeps


def _score_clear(engine, pp, cfg, tokens, spec,
                 variant=FULL_VARIANT, batch: int = 256) -> np.ndarray:
    """Entropy scores of `tokens` (N, S) under a clear proxy, `batch` rows
    at a time on the proxy's device, as float32 numpy."""
    dev = pp["embed"].device
    out = []
    with torch.no_grad():
        for i in range(0, tokens.shape[0], batch):
            t = torch.as_tensor(tokens[i:i + batch], device=dev)
            out.append(proxy_entropy(engine, pp, cfg, t, spec, variant)
                       .cpu().numpy())
    return np.concatenate(out)


def clear_phase(engine, pp, cfg, pool_tokens, surviving, spec, keep: int,
                variant=FULL_VARIANT, batch: int = 256):
    """One clear sieve phase over the pool rows `surviving`: returns the
    kept rows (sorted pool indices), the appraisal (mean entropy of the
    kept) and every survivor's score."""
    ents = _score_clear(engine, pp, cfg, pool_tokens[surviving], spec,
                        variant, batch)
    top_local = np.argsort(ents)[-keep:]
    appraisal = float(np.mean(ents[top_local]))
    return np.sort(surviving[top_local]), appraisal, ents


def selection_plan(key, target_params, cfg: ArchConfig, pool_tokens,
                   sel: SelectionConfig, *, n_classes: int,
                   boot_labels_fn=None):
    """The full pipeline as a GENERATOR: stages 1/3 and every clear-side
    step run inline; each MPC scoring phase is yielded as a
    `PhaseRequest` and the driver sends `(ent_sh, reports)` back.
    Returns (via StopIteration.value) the SelectionResult. `key` is a
    `prng` key; `pool_tokens` a numpy (N, S) array."""
    pool_tokens = np.asarray(pool_tokens)
    n = pool_tokens.shape[0]
    budget = int(round(sel.budget_frac * n))
    n_boot = max(8, int(round(sel.boot_frac * n)))
    rng = np.random.default_rng(int(prng.randint(key, (), 0, 2 ** 31 - 1)))

    # ---- stage 1: bootstrap purchase (random, clear) --------------------
    boot_idx = np.sort(rng.choice(n, size=n_boot, replace=False))
    boot_tokens = pool_tokens[boot_idx]
    boot_labels = boot_labels_fn(boot_idx)

    # ---- restart support: resume after the last completed phase ---------
    fp = None
    resume_from = 0
    completed: dict[int, dict] = {}
    if sel.checkpoint_dir or sel.mode == "mpc":
        fp = _run_fingerprint(sel, n, budget, boot_idx, target_params,
                              pool_tokens)
    if sel.checkpoint_dir and sel.resume:
        for d in _load_phase_checkpoints(sel.checkpoint_dir):
            if d.get("fp") == fp and d["phase"] < len(sel.phases):
                completed[d["phase"]] = d
        # only a contiguous prefix is resumable
        while resume_from in completed:
            resume_from += 1
    resumed_appraisal = (completed[resume_from - 1].get("appraisal", 0.0)
                         if resume_from else 0.0)

    # ---- proxy generation (model-owner side, clear) ---------------------
    max_l = max(ph.n_layers for ph in sel.phases)
    key, kg, kf = prng.split(key, 3).unbind(-2)
    if resume_from < len(sel.phases):
        m_g = proxy_mod.extract_backbone(target_params, max_l)
        m_g, _ = target_mod.finetune(kf, m_g, cfg, boot_tokens, boot_labels,
                                     steps=sel.finetune_steps, n_layers=max_l)
    proxies = []
    for pi, ph in enumerate(sel.phases):
        key, kb, ki = prng.split(key, 3).unbind(-2)
        if pi < resume_from:          # phase already checkpointed: no proxy
            proxies.append(None)
            continue
        stats = proxy_mod.collect_stats(m_g, cfg, boot_tokens[:256], ph)
        pp = proxy_mod.build_proxy(kb, m_g, cfg, stats, ph,
                                   seq_len=pool_tokens.shape[1],
                                   n_classes=n_classes,
                                   exvivo_steps=sel.exvivo_steps)
        pp = proxy_mod.invivo_finetune(ki, pp, cfg, boot_tokens, boot_labels,
                                       ph, steps=sel.invivo_steps)
        proxies.append(pp)

    # ---- stage 2: multi-phase MPC sieve ----------------------------------
    surviving = np.setdiff1d(np.arange(n), boot_idx)
    keeps = _phase_keep(len(surviving), budget - n_boot, sel.phases)
    survivors_log = []
    exec_reports: list[PhaseReport] = []
    phase_scores: list[np.ndarray] = []
    appraisal = resumed_appraisal
    for pi, (ph, pp, keep) in enumerate(zip(sel.phases, proxies, keeps)):
        key, ks = prng.split(key).unbind(-2)
        if pi < resume_from:
            surviving = np.asarray(completed[pi]["surviving"], dtype=int)
            survivors_log.append(surviving.copy())
            continue
        tok = pool_tokens[surviving]
        if sel.mode == "mpc":
            ent_sh, reports = yield PhaseRequest(
                phase=pi, key=ks, pp=pp, tokens=tok, spec=ph, keep=keep,
                batch=min(sel.score_batch, len(surviving)), fingerprint=fp)
            exec_reports.extend(reports)
            phase_scores.append(ent_sh.sh.cpu().numpy())
            qs_wave = sel.executor.wave if sel.executor.fuse else 1
            top_local = quickselect.top_k_indices(ent_sh, keep,
                                                  seed=1234 + pi,
                                                  wave=qs_wave)
            appraisal = _mean_as_xla(
                reconstruct(ent_sh[np.asarray(top_local)]).double()
                / ent_sh.ring.scale)
        else:
            ents = _score_clear(sel.engine, pp, cfg, tok, ph, sel.variant)
            top_local = np.argsort(ents)[-keep:]
            appraisal = float(np.mean(ents[top_local]))
        surviving = np.sort(surviving[top_local])
        survivors_log.append(surviving.copy())
        _checkpoint_phase(sel, pi, surviving, fp, appraisal)

    selected = np.sort(np.concatenate([boot_idx, surviving]))
    return SelectionResult(selected, boot_idx, survivors_log, appraisal,
                           exec_reports, resumed_phases=resume_from,
                           phase_scores=phase_scores)


def _mean_as_xla(x: torch.Tensor) -> float:
    """The float64 mean as the JAX package's `jnp.mean` computes it on the
    CPU for a short vector: summed left to right, times 1 / n (XLA turns
    the division by the constant count into that product), so the
    appraisal is bitwise JAX's."""
    total = 0.0
    for v in x.cpu().tolist():
        total += v
    return total * (1.0 / x.numel())


def run_selection(key, target_params, cfg: ArchConfig, pool_tokens,
                  sel: SelectionConfig, *, n_classes: int,
                  boot_labels_fn=None) -> SelectionResult:
    """Full pipeline. `boot_labels_fn(idx) -> labels` models the clear
    purchase of the bootstrap sample (labels delivered with the data).
    The sequential driver over `selection_plan`: one fresh WaveExecutor
    per yielded phase."""
    plan = selection_plan(key, target_params, cfg, pool_tokens, sel,
                          n_classes=n_classes, boot_labels_fn=boot_labels_fn)
    sent = None
    try:
        while True:
            req = plan.send(sent)
            execu = WaveExecutor(dataclasses.replace(sel.executor,
                                                     batch=req.batch))
            ent_sh = execu.score_phase(req.key, req.pp, cfg, req.tokens,
                                       req.spec, variant=sel.variant)
            sent = (ent_sh, execu.reports)
    except StopIteration as done:
        return done.value


def _run_fingerprint(sel: SelectionConfig, n_pool: int, budget: int,
                     boot_idx, target_params, pool_tokens) -> str:
    """Identifies one logical selection run: pool contents, budget,
    bootstrap draw, target weights and config. The digest hashes the
    same bytes in the same order as the JAX package's (leaves in pytree
    order), so the hex digests agree for the same inputs."""
    ex = sel.executor
    cfg_desc = (sel.mode,
                getattr(sel.engine, "ring", None) and sel.engine.ring.name,
                tuple(sorted(sel.variant)),
                tuple((p.n_layers, p.n_heads, p.mlp_dim, p.selectivity)
                      for p in sel.phases),
                (sel.exvivo_steps, sel.invivo_steps, sel.finetune_steps,
                 sel.boot_frac),
                (ex.wave, ex.coalesce, ex.overlap, ex.fuse, ex.batch,
                 ex.protocol, sel.score_batch)
                if sel.mode == "mpc" else None)
    h = hashlib.sha1(np.asarray(boot_idx, dtype=np.int64).tobytes())
    h.update(np.asarray([n_pool, budget], dtype=np.int64).tobytes())
    h.update(repr(cfg_desc).encode())
    for leaf in tree_leaves(target_params):
        h.update(leaf.detach().cpu().numpy().tobytes())
    h.update(np.ascontiguousarray(np.asarray(pool_tokens)).tobytes())
    return h.hexdigest()[:16]


def _load_phase_checkpoints(ckpt_dir: str) -> list[dict]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in sorted(os.listdir(ckpt_dir)):
        if f.startswith("phase_") and f.endswith(".json"):
            with open(os.path.join(ckpt_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def _checkpoint_phase(sel: SelectionConfig, phase: int, surviving,
                      fp: str, appraisal: float) -> None:
    if not sel.checkpoint_dir:
        return
    os.makedirs(sel.checkpoint_dir, exist_ok=True)
    path = os.path.join(sel.checkpoint_dir, f"phase_{phase}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"phase": phase, "surviving": surviving.tolist(),
                   "fp": fp, "appraisal": appraisal}, f)
    os.replace(tmp, path)


def appraise_threshold(ent_sh: Share, idx, threshold: float, key) -> bool:
    """Paper §4.1 appraisal: jointly compare the (encrypted) average
    entropy of the selected set against a public threshold and reveal
    ONLY the one-bit outcome (avg > threshold)."""
    from repro_torch.mpc import compare, ops as mops
    sel = ent_sh[np.asarray(idx)]
    avg = mops.mean(sel, axis=0, key=prng.fold_in(key, 1))
    thr = mops.add_public(mops.neg(avg), threshold)      # thr - avg
    bit = compare.reveal_lt(thr, thr.with_sh(torch.zeros_like(thr.sh)))
    return bool(bit)


def resume_phase(sel: SelectionConfig) -> tuple[int, np.ndarray] | None:
    """Restart support: latest completed phase's survivor set."""
    if not sel.checkpoint_dir:
        return None
    best = None
    for d in _load_phase_checkpoints(sel.checkpoint_dir):
        if best is None or d["phase"] > best[0]:
            best = (d["phase"], np.asarray(d["surviving"]))
    return best
