#!/usr/bin/env python3
"""Where does the selection pipeline first go non-finite from a random
target? The JAX package and the port, on the CPU, side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/selection_divergence.py \\
        [--d-model 768] [--layers 3] [--seq 512] [--finetune 200] \\
        [--exvivo 100] [--invivo 150]

A random target (d_model given, heads of 64, d_ff 4 d_model, vocab
30,522) is built by the JAX package from a seed and carried across; both
packages then run `run_selection` in mode="clear" on a pool of 64 (8
bootstrap rows) with `two_phase_default(d_model / 64)` and the step
counts given. `selection_plan` cuts M_g to the phases' deepest proxy (3
layers for two_phase_default), so `--layers 3` runs the same network as
a full-depth target. Every stage is wrapped: M_g's finetune and each
in-vivo finetune report their per-step losses (the loss read through
`models.common.cross_entropy`) and the first step whose loss is not
finite; each phase reports whether its statistics, its ex-vivo proxy
and its tuned proxy are finite, with their largest magnitudes and the
proxy's largest |logit| on the bootstrap rows before and after in-vivo.
Prints one JSON line per package, then one line naming the first
non-finite stage of each. It runs the JAX package, so it runs on the
CPU only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np


def _arrays(x):
    """Every array in a tree of dicts, lists, tuples and objects."""
    if hasattr(x, "detach"):
        yield x.detach().cpu().numpy()
    elif isinstance(x, dict):
        for v in x.values():
            yield from _arrays(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _arrays(v)
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        yield np.asarray(x)
    elif hasattr(x, "__dict__"):
        yield from _arrays(vars(x))


def _summary(x) -> dict:
    arrs = [a.astype(np.float64) for a in _arrays(x) if a.size
            and np.issubdtype(a.dtype, np.floating)]
    return {"finite": bool(all(np.isfinite(a).all() for a in arrs)),
            "max_abs": float(max(np.nanmax(np.abs(a)) for a in arrs))}


def _first_bad(losses: list) -> int | None:
    return next((i for i, x in enumerate(losses) if not math.isfinite(x)),
                None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--finetune", type=int, default=200)
    ap.add_argument("--exvivo", type=int, default=100)
    ap.add_argument("--invivo", type=int, default=150)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.paper_targets import TINY_TARGET as J_TINY
    from repro.core import proxy as j_proxy, selection as j_sel
    from repro.core import target as j_target
    from repro.data.tasks import make_classification_task
    from repro.engine import ClearEngine as JClear, proxy_logits as j_logits
    from repro.models import common as j_common
    from repro_torch.configs.paper_targets import TINY_TARGET
    from repro_torch.core import proxy, selection, target, tree
    from repro_torch.engine import ClearEngine, proxy_logits
    from repro_torch.models import common
    from repro_torch.mpc import prng

    d = args.d_model
    geom = dict(n_layers=args.layers, d_model=d, n_heads=d // 64,
                n_kv_heads=d // 64, d_head=64, d_ff=4 * d, vocab_size=30522)
    j_cfg = dataclasses.replace(J_TINY, **geom)
    cfg = dataclasses.replace(TINY_TARGET, **geom)
    task = make_classification_task(8, n_pool=64, n_test=8, seq=args.seq,
                                    vocab=geom["vocab_size"], n_classes=2)
    jparams = j_target.init_classifier(jax.random.key(8), j_cfg, 2)
    steps = dict(finetune_steps=args.finetune, exvivo_steps=args.exvivo,
                 invivo_steps=args.invivo)

    def run(name, sel_mod, proxy_mod, target_mod, common_mod, log_loss,
            sync, key, params, c, logits_fn, eng):
        stages, losses = [], []
        orig = {(m, n): getattr(m, n) for m, n in (
            (target_mod, "finetune"), (proxy_mod, "collect_stats"),
            (proxy_mod, "build_proxy"), (proxy_mod, "invivo_finetune"),
            (common_mod, "cross_entropy"))}

        def ce(*a, **kw):
            loss = orig[common_mod, "cross_entropy"](*a, **kw)
            log_loss(losses, loss)
            return loss

        def trained(stage, fn):
            def wrapped(*a, **kw):
                losses.clear()
                out = fn(*a, **kw)
                sync()
                ls = list(losses)
                stages.append({"stage": stage, "steps": len(ls),
                               "first_losses": ls[:3], "last_loss":
                               ls[-1] if ls else None,
                               "first_nonfinite_step": _first_bad(ls),
                               "params": _summary(out)})
                return out
            return wrapped

        def stats_fn(*a, **kw):
            out = orig[proxy_mod, "collect_stats"](*a, **kw)
            stages.append({"stage": "stats", **_summary(out)})
            return out

        def build_fn(k, pg, cfg_, st, spec, **kw):
            out = orig[proxy_mod, "build_proxy"](k, pg, cfg_, st, spec, **kw)
            rec = {"stage": f"ex-vivo {spec}", "params": _summary(out)}
            rec["max_abs_logit"] = float(np.abs(np.asarray(logits_fn(
                eng, out, cfg_, task.pool_tokens[:8], spec))).max())
            stages.append(rec)
            return out

        invivo = trained("in-vivo", orig[proxy_mod, "invivo_finetune"])

        def invivo_fn(k, pp, cfg_, tok, lab, spec, **kw):
            out = invivo(k, pp, cfg_, tok, lab, spec, **kw)
            stages[-1]["stage"] = f"in-vivo {spec}"
            stages[-1]["max_abs_logit"] = float(np.abs(np.asarray(
                logits_fn(eng, out, cfg_, tok, spec))).max())
            return out
        for (m, n), f in zip(orig, (
                trained("M_g finetune", orig[target_mod, "finetune"]),
                stats_fn, build_fn, invivo_fn, ce)):
            setattr(m, n, f)
        try:
            t0 = time.time()
            res = sel_mod.run_selection(
                key, params, c, task.pool_tokens,
                sel_mod.SelectionConfig(sel_mod.two_phase_default(d // 64),
                                        **steps),
                n_classes=2, boot_labels_fn=lambda i: task.pool_labels[i])
        finally:
            for (m, n), f in orig.items():
                setattr(m, n, f)
        out = {"package": name, **geom, "seq": args.seq, **steps,
               "stages": stages, "appraisal": str(res.appraisal_entropy),
               "boot_idx": np.asarray(res.boot_idx).tolist(),
               "wall_s": time.time() - t0}
        print(json.dumps(out), flush=True)
        return out

    def jax_log(losses, loss):
        jax.debug.callback(lambda x: losses.append(float(x)), loss)

    def torch_log(losses, loss):
        losses.append(float(loss.detach()))

    runs = [
        run("jax", j_sel, j_proxy, j_target, j_common, jax_log,
            jax.effects_barrier, jax.random.key(0), jparams, j_cfg,
            lambda e, pp, c, tok, s: j_logits(e, pp, c, jnp.asarray(tok), s),
            JClear()),
        run("repro_torch", selection, proxy, target, common, torch_log,
            lambda: None, prng.key(0),
            tree.to_device(jax.tree.map(np.asarray, jparams), "cpu"), cfg,
            lambda e, pp, c, tok, s: proxy_logits(
                e, pp, c, torch.as_tensor(tok), s).detach(), ClearEngine())]

    def first_nonfinite(stages):
        for i, s in enumerate(stages):
            if (s.get("first_nonfinite_step") is not None
                    or not s.get("params", s).get("finite", True)
                    or not math.isfinite(s.get("max_abs_logit", 0.0))):
                return f"stage {i} ({s['stage']})"
        return None
    print(json.dumps({r["package"]: first_nonfinite(r["stages"])
                      for r in runs}), flush=True)


if __name__ == "__main__":
    main()
