"""THE proxy forward (paper §4.2/§4.3) — written once, engine-generic.

The port of repro/engine/forward.py, op for op. Every execution
substrate runs this exact function: the clear float path, the
share-level MPC path (the private sieve, driven by the wave executor),
and the meta-tensor cost probe.  Clear/MPC parity is structural, not maintained by
discipline: there is no second copy of the layer math to drift.

The op order below is load-bearing for the accounting contract: the
MPC op stream it induces is mirrored record-for-record by
the JAX package's `mpc/costs.proxy_exec_cost` and must equal the JAX
forward's stream record for record, and the wave executor's realized
flight ledger must reproduce that stream exactly
(`iosched.ledger_agrees`).
Reorder ops here and the mirror test tells you immediately.  The
`eng.fused(label)` groups are part of that contract too: under a
`fusion.flight_scope` they bound the fused flights, and the analytic
mirror places its GroupBegin/GroupEnd markers at the same spots.
"""
from repro_torch.engine.base import resolve_variant


def _mlp_at(mlps, li: int):
    """Per-layer MLP params: lists index directly; stacked dicts slice."""
    if isinstance(mlps, (list, tuple)):
        return mlps[li]
    return {k: v[li] for k, v in mlps.items()}


def _proxy_layer(eng, x, pp, li, cfg, spec, variant):
    """One proxy block: MLP-LayerNorm -> pruned attention -> residual."""
    dh = cfg.d_head
    w = spec.n_heads
    wk = min(w, cfg.n_kv_heads)
    g = w // wk
    b, s, d = eng.shape(x)
    # MLP-LayerNorm: numerator exact, reciprocal-sqrt emulated ("ln").
    # The stat openings (the variance Beaver open plus whatever forced
    # truncations the scale lattice fires — pow2 means fold for free)
    # form one fused flight under a flight_scope — `eng.fused` is a
    # no-op on wireless substrates, so clear/MPC parity is untouched.
    with eng.fused("ln_stats"):
        mu = eng.mean(x, axis=-1)
        xc = eng.sub(x, eng.broadcast(eng.reshape(mu, (b, s, 1)), (b, s, d)))
        var = eng.mean(eng.mul(xc, xc), axis=-1)
    inv = eng.ln_inv(pp, li, eng.reshape(var, (b * s, 1)), variant)
    h = eng.mul(xc, eng.broadcast(eng.reshape(inv, (b, s, 1)), (b, s, d)))
    gamma = eng.reshape(eng.index(pp["ln_scale"], li), (1, 1, d))
    h = eng.mul(h, eng.broadcast(gamma, (b, s, d)))
    beta = eng.reshape(eng.index(pp["ln_bias"], li), (1, 1, d))
    h = eng.add(h, eng.broadcast(beta, (b, s, d)))
    # pruned attention: per-projection matmuls, GQA head grouping. The
    # three projections consume the same input and nothing of each other
    # — the canonical independent group, one (eps, delta) flight for all
    # three; the shared input's forced truncation (ops.force memo) is
    # paid once and rides the same flight.
    ap = pp["attn"]
    h2 = eng.reshape(h, (b * s, d))
    with eng.fused("qkv"):
        q = eng.matmul(h2, eng.index(ap["wq"], li))
        k = eng.matmul(h2, eng.index(ap["wk"], li))
        v = eng.matmul(h2, eng.index(ap["wv"], li))
    if "bq" in ap:
        q = eng.add(q, eng.broadcast(eng.index(ap["bq"], li), (b * s, w * dh)))
        k = eng.add(k, eng.broadcast(eng.index(ap["bk"], li),
                                     (b * s, wk * dh)))
        v = eng.add(v, eng.broadcast(eng.index(ap["bv"], li),
                                     (b * s, wk * dh)))
    # scores per (batch, kv-head, group): fold heads into batch dims
    qT = eng.moveaxis(eng.reshape(q, (b, s, wk, g, dh)), 1, 3)  # b wk g s dh
    kT = eng.swapaxes(eng.moveaxis(eng.reshape(k, (b, s, wk, dh)), 2, 1),
                      -1, -2)                                    # b wk dh s
    kT = eng.broadcast(eng.reshape(kT, (b, wk, 1, dh, s)), (b, wk, g, dh, s))
    o = eng.attend(pp, li, qT, kT, v, variant)                   # b wk g s dh
    o2 = eng.reshape(eng.moveaxis(o, 3, 1), (b * s, w * dh))
    out = eng.matmul(o2, eng.index(ap["wo"], li))
    return eng.add(x, eng.reshape(out, (b, s, d)))


def attend_materialized(eng, pp, li, qT, kT, v, variant):
    """The attention block, op for op: scores -> `attn_probs` -> probs @ V.

    qT (b, wk, g, s, dh) and kT (b, wk, g, dh, s) are the head-folded
    query and key; v is the value projection (b * s, wk * dh). The S x S
    scores and probabilities are materialized. This is every engine's
    `attend` except where a kernel computes the same function on the
    card (ClearEngine, "sm" variant), so the MPC op stream — and with it
    the ledger — is the JAX forward's, record for record.
    """
    b, wk, g, s, dh = eng.shape(qT)
    scores = eng.mul_public(eng.matmul(qT, kT), dh ** -0.5)      # b wk g s s
    probs = eng.attn_probs(pp, li, eng.reshape(scores, (b * wk * g * s, s)),
                           variant)
    probs = eng.reshape(probs, (b, wk, g, s, s))
    vT = eng.moveaxis(eng.reshape(v, (b, s, wk, dh)), 2, 1)      # b wk s dh
    vT = eng.broadcast(eng.reshape(vT, (b, wk, 1, s, dh)), (b, wk, g, s, dh))
    return eng.matmul(probs, vT)                                 # b wk g s dh


def proxy_logits(eng, pp, cfg, x_in, spec, variant=None):
    """Proxy classifier logits: embed -> l pruned blocks -> mean-pool."""
    variant = resolve_variant(eng, variant)
    x = eng.embed(pp, x_in, cfg)
    for li in range(spec.n_layers):
        x = _proxy_layer(eng, x, pp, li, cfg, spec, variant)
    pooled = eng.mean(x, axis=1)
    return eng.matmul(pooled, pp["cls_head"])


def proxy_entropy(eng, pp, cfg, x_in, spec, variant=None):
    """Per-example entropy score — the sieve's ranking signal.

    `x_in` is engine-native input: token ids for ClearEngine (it owns
    the embedding lookup), shared embedded activations (B, S, d) for
    MPCEngine (the data owner shares one-hot rows; the embedding matmul
    is folded into share generation, priced by costs.py).
    """
    variant = resolve_variant(eng, variant)
    logits = proxy_logits(eng, pp, cfg, x_in, spec, variant)
    return eng.entropy_head(pp, logits, variant)
