#!/usr/bin/env python3
"""Where does RING64's local truncation wrap in chip_smoke.py phase 9a?

    python3 tools/ring64_trunc_wraps.py [--seed 0] [--keys 90,190,290]
        [--variants full,no-sm,no-ln,no-se,quad_sm,poly_sm] [--out JSON]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ring64_trunc_wraps.py \\
        --jax-witness chiprun_out/ring64_trunc_wraps.json

On RING64 the 2PC backend truncates locally (`Additive2PC.trunc`: an
arithmetic shift of each share component, CrypTen's choice): an element
whose share pair crosses the signed boundary comes out off by about
2**(64 - shift), with probability |v| / 2**64 for a value v. The first
form runs on one NVIDIA GPU and repeats phase 9a on RING64: chip_smoke's
phase-3 proxies and phase-2 proxy <3,12,16> at BERT-base width, 9a's
pool of VAR_BATCHES batches of 4 at seq 512 and 9a's key (seed + 90,
then seed + each other `--keys` offset), once through the executor as
9a runs it (coalesced) and once serially with every local truncation
checked: the reconstructed value before it, shifted, against the
reconstructed value after it. The two runs' scores must be bitwise
equal (the schedule points agree by the executor's contract). Per
variant and key it prints one JSON line: each candidate's
|decoded MPC - ClearEngine| (ClearEngine with the same variant), the
expected number of wraps (the sum of |v| / 2**64 over every truncated
element), and every wrapped element with its layer, its line of
engine/forward.py, its index, its candidate row, its two input
components, shift and carried exponent. It writes the same to `--out`
(chiprun_out/ring64_trunc_wraps.json by default).

The second form runs on the CPU: it feeds each wrapped element's two
input components to the JAX package's `Additive2PC.trunc` and to the
port's and checks that both give the components the card gave. It
imports the JAX package, so it is not run on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "ring64_trunc_wraps.json")
VARIANT_NAMES = ("full", "no-sm", "no-ln", "no-se", "quad_sm", "poly_sm")


def _site() -> dict:
    """The proxy layer and the line of engine/forward.py that reached
    this truncation, and the executor's wave and lane."""
    f, out, funcs = sys._getframe(2), {}, []
    while f is not None:
        code = f.f_code
        if "repro_torch" in code.co_filename and len(funcs) < 6:
            funcs.append(f"{os.path.basename(code.co_filename)}:"
                         f"{f.f_lineno}:{code.co_name}")
        if code.co_name == "_proxy_layer" and "layer" not in out:
            out["layer"] = f.f_locals["li"]
            out["forward_line"] = f.f_lineno
        if code.co_name == "proxy_entropy" and "forward_line" not in out:
            out["forward_line"] = f.f_lineno
            out["layer"] = "head"
        if code.co_name == "dispatch" and "wi" in f.f_locals:
            out["wave"], out["lane"] = f.f_locals["wi"], f.f_locals.get("li")
        f = f.f_back
    out["stack"] = funcs
    return out


def _checked_trunc(real, record):
    import torch

    def trunc(self, x, key, *, shift=None):
        out = real(self, x, key, shift=shift)
        ring = x.ring
        if ring.bits < 64 and key is not None:
            return out                       # RING32's exact pair
        s = ring.frac_bits if shift is None else shift
        v = x.sh[0] + x.sh[1]                # wraps as the ring does
        got = out.sh[0] + out.sh[1]
        bad = (got - (v >> s)).abs() > 1
        site = _site()
        call = {"shape": list(x.shape), "shift": s, "fb": x.fb,
                "layer": site.get("layer"),
                "forward_line": site.get("forward_line"),
                "max_abs_log2": float(torch.log2(
                    v.abs().max().double().clamp(min=1))),
                "expected_wraps": float((v.abs().double()
                                         / 2.0 ** 64).sum()),
                "wrapped": int(bad.sum())}
        if call["wrapped"]:
            n = x.sh[0].numel()
            per_row = n // record["batch"]
            flat = bad.reshape(-1).nonzero().flatten()[:8].tolist()
            s0, s1 = x.sh[0].reshape(-1), x.sh[1].reshape(-1)
            o0, o1 = out.sh[0].reshape(-1), out.sh[1].reshape(-1)
            call["stack"] = site["stack"]
            call["elements"] = [{
                "flat_index": i,
                "index": [int(t) for t in torch.unravel_index(
                    torch.tensor(i), tuple(x.shape))],
                "row": (site["wave"] * record["wave"] + site["lane"])
                * record["batch"] + i // per_row,
                "in": [int(s0[i]), int(s1[i])],
                "out": [int(o0[i]), int(o1[i])],
                "value": float(v.reshape(-1)[i].double() / 2.0 ** x.fb),
                "after": float(got.reshape(-1)[i].double()
                               / 2.0 ** (x.fb - s))} for i in flat]
        record["calls"].append(call)
        return out
    return trunc


def card(args) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ring64_trunc_wraps: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.core.executor import ExecConfig, WaveExecutor
    from repro_torch.engine import VARIANTS, ClearEngine, proxy_entropy
    from repro_torch.kernels import build
    from repro_torch.mpc import prng
    from repro_torch.mpc.protocols.additive2pc import Additive2PC
    from repro_torch.mpc.ring import RING64
    from repro_torch.mpc.sharing import reconstruct
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cfg, specs, pps = cs.build_proxies(args.seed)
    spec, pp = specs[1], pps[1]
    pool = np.random.default_rng(args.seed + 9).integers(
        0, cfg.vocab_size, (cs.VAR_BATCHES * cs.BATCH, cs.SEQ))
    tok = torch.as_tensor(pool, device="cuda")
    real = Additive2PC.trunc
    results = []
    for name in args.variants.split(","):
        variant = VARIANTS[name]
        clear = torch.cat([
            proxy_entropy(ClearEngine(), pp, cfg, tok[i:i + cs.BATCH], spec,
                          variant)
            for i in range(0, len(tok), cs.BATCH)]).double()
        for off in (int(k) for k in args.keys.split(",")):
            scores = {}
            record = {"calls": [], "batch": cs.BATCH, "wave": cs.WAVE}
            for coalesce in (True, False):
                ex = WaveExecutor(ExecConfig(
                    wave=cs.WAVE, coalesce=coalesce, overlap=True,
                    fuse=True, batch=cs.BATCH, ring=RING64, device="cuda"))
                if not coalesce:
                    Additive2PC.trunc = _checked_trunc(real, record)
                t0 = time.time()
                try:
                    ent = ex.score_phase(prng.key(args.seed + off,
                                                  device="cuda"),
                                         pp, cfg, pool, spec, variant)
                    scores[coalesce] = reconstruct(ent)
                    torch.cuda.synchronize()
                finally:
                    Additive2PC.trunc = real
                wall = time.time() - t0
            if not torch.equal(scores[True], scores[False]):
                print(f"{name} key +{off}: serial and coalesced scores "
                      "differ", file=sys.stderr)
                return 1
            err = (RING64.decode(scores[False]).double() - clear).abs()
            calls = record["calls"]
            res = {"variant": name, "key_offset": off,
                   "device": smi, "checked_wall_s": wall,
                   "err_per_row": [float(e) for e in err],
                   "truncations": len(calls),
                   "elements": sum(int(np.prod(c["shape"])) for c in calls),
                   "expected_wraps": sum(c["expected_wraps"]
                                         for c in calls),
                   "wrapped": sum(c["wrapped"] for c in calls),
                   "max_abs_log2": max(c["max_abs_log2"] for c in calls),
                   "wraps": [c for c in calls if c["wrapped"]]}
            results.append(res)
            print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


def jax_witness(path: str) -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.mpc.ring import RING64 as J_RING64
    from repro.mpc.sharing import Share as JShare
    from repro_torch.mpc.ring import RING64
    from repro_torch.mpc.sharing import Share
    results = json.load(open(path))
    n, ok = 0, True
    with jax.enable_x64(True):
        for res in results:
            for call in res["wraps"]:
                for el in call["elements"]:
                    sh = [[el["in"][0]], [el["in"][1]]]
                    j = JShare(jnp.asarray(sh, jnp.int64), J_RING64,
                               fb=call["fb"])
                    jo = j.backend.trunc(j, None, shift=call["shift"])
                    t = Share(torch.tensor(sh, dtype=torch.int64), RING64,
                              fb=call["fb"])
                    to = t.backend.trunc(t, None, shift=call["shift"])
                    jax_out = [int(x) for x in jnp.ravel(jo.sh)]
                    port_out = [int(x) for x in to.sh.reshape(-1)]
                    same = jax_out == el["out"] == port_out
                    ok &= same
                    n += 1
                    print(json.dumps({
                        "variant": res["variant"],
                        "key_offset": res["key_offset"],
                        "layer": call["layer"],
                        "forward_line": call["forward_line"],
                        "row": el["row"], "index": el["index"],
                        "value": el["value"], "after": el["after"],
                        "card": el["out"], "jax": jax_out,
                        "port_cpu": port_out, "equal": same}))
    print(f"{n} wrapped elements; JAX == port == card: {ok}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", default="90",
                    help="key offsets from --seed (9a's is 90)")
    ap.add_argument("--variants", default=",".join(VARIANT_NAMES))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jax-witness", metavar="JSON", default=None,
                    help="check the recorded wraps against the JAX "
                         "package's trunc on the CPU")
    args = ap.parse_args(argv)
    if args.jax_witness:
        return jax_witness(args.jax_witness)
    return card(args)


if __name__ == "__main__":
    sys.exit(main())
