"""Analytic MPC cost formulas (rounds / bytes / local flops) — the port
of repro/mpc/costs.py, formula for formula.

These mirror the executable protocols in ops.py/nonlinear.py exactly but
evaluate at *paper scale* (BERT over 42K-188K candidates) without moving
tensors, producing the Ledgers that the schedule search, the selection
launcher's paper-scale delay and the IO scheduler consume. Element size
defaults to CrypTen's int64 ring (8 B).

Tag convention ("bw" bandwidth-bound / "lat" latency-bound) feeds the
paper's §4.4 scheduler: comparisons and low-dim ops are "lat", big-tensor
Beaver openings are "bw".

Ring parameterization: the primitive helpers take an optional RingSpec.
RING64 (default) truncates locally — free, no record, CrypTen's choice.
RING32 uses dealer-assisted truncation: every fixed-point
product pays one extra opening round (`trunc_open`), mirrored here
record-for-record against the dealer path of `Additive2PC.trunc`.

Protocol parameterization: the same primitives take `protocol=` and
mirror the chosen backend's records exactly:
  2pc       Beaver opening flights (bytes ~ inputs) + dealer bytes in
            the OFFLINE channel (tag="offline", 0 rounds: triples and,
            on RING32, truncation pairs) in the positions the
            executable dealer records them.
  3pc       one resharing flight per mul/matmul (bytes ~ OUTPUT) and,
            per forced truncation, a 0-round `trunc_reshare` record
            pricing the re-replication component on the resharing
            flight; zero offline records — the dealer-free cost
            profile.
  spdz2pc   the malicious tier: MAC'd dealer randomness (4 components
            per element — DOUBLE the semi-honest offline bytes), a
            sacrifice flight before every Beaver open, dealer
            truncation pairs on BOTH rings, and the constant-size
            batched MAC check + MAC-key shipment at the forward
            boundary (`proxy_exec_cost` tail).
  aby3trunc 3pc resharing costs everywhere, except each forced
            truncation is one exact `trunc2` subprotocol: rounds=2
            (a batcher barrier), 6 components of wire.

`proxy_exec_cost` asks the registered backend (mpc/protocols/) whether
its truncation is exact, so it takes any of the four names and raises
ValueError for an unknown one.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.mpc.comm import Ledger, CostRecord
from repro_torch.mpc.compare import CMP_ROUNDS, CMP_BYTES
from repro_torch.mpc.nonlinear import (EXP_ITERS, RECIP_ITERS, RSQRT_ITERS,
                                       LOG_ITERS)
from repro_torch.mpc.ring import RING64, RingSpec

EB = 8  # default ring element bytes (int64)


def _led(*recs: CostRecord) -> Ledger:
    led = Ledger()
    for r in recs:
        led.add(r)
    return led


def _offline(n_elems: int, op: str, ring: RingSpec) -> CostRecord:
    """Dealer-shipped correlated randomness (mirrors
    additive2pc._record_offline): 0 rounds, both parties' components."""
    return CostRecord(op, 0, 2 * ring.elem_bytes * n_elems, n_elems, 0,
                      "offline")


def _offline_mac(n_elems: int, op: str, ring: RingSpec) -> CostRecord:
    """MAC'd dealer randomness (mirrors spdz2pc._record_offline_mac):
    4 components per element (value + MAC, both parties)."""
    return CostRecord(op, 0, 4 * ring.elem_bytes * n_elems, n_elems, 0,
                      "offline")


# protocols sharing the replicated-3pc wire profile for mul/matmul
_P3 = ("3pc", "aby3trunc")


def merge(*ledgers: Ledger) -> Ledger:
    out = Ledger()
    for led in ledgers:
        out.records.extend(led.records)
    return out


# ---------------------------------------------------------------------------
# primitive costs
# ---------------------------------------------------------------------------

def open_cost(n: int, op: str = "open", *, ring: RingSpec = RING64,
              protocol: str = "2pc") -> Ledger:
    parties = 3 if protocol in _P3 else 2
    return _led(CostRecord(op, 1, parties * ring.elem_bytes * n, n, 0, "bw"))


def trunc_cost(n: int, op: str = "trunc_open", *,
               ring: RingSpec = RING64, protocol: str = "2pc") -> Ledger:
    """One forced truncation of n elements (ops.force / backend.trunc
    with a key) — the SAME records for any shift, which is what makes
    folding a chain of deferred rescales into one trunc a pure win:
      2pc RING64   local arithmetic shift — free, no record
      2pc RING32   dealer pair (offline bytes) + one trunc_open flight
      3pc both     local regrouped shift + the re-replication message
                   riding the next resharing flight: 0 rounds, one
                   output component's bytes
      spdz2pc both MAC'd dealer pair + one partial-open flight — local
                   shifting is not MAC-preserving, so even RING64 pays
                   (the malicious overhead curve's truncation story)
      aby3trunc    one exact trunc2 subprotocol: rounds=2 (the masked
                   open depends on the pair-generation messages — a
                   batcher barrier), 6 components of wire, both rings."""
    if protocol == "aby3trunc":
        return _led(CostRecord(op, 2, 6 * ring.elem_bytes * n, n, 0, "bw"))
    if protocol == "3pc":
        return _led(CostRecord(op + ".reshare", 0, ring.elem_bytes * n, n,
                               0, "bw"))
    if protocol == "spdz2pc":
        return _led(_offline_mac(2 * n, op + ".pair", ring),
                    CostRecord(op, 1, 2 * ring.elem_bytes * n, n, 0, "bw"))
    if ring.bits >= 64:
        return Ledger()
    return _led(_offline(2 * n, op + ".pair", ring),
                CostRecord(op, 1, 2 * ring.elem_bytes * n, n, 0, "bw"))


def mul_cost(n: int, op: str = "beaver_mul", *,
             ring: RingSpec = RING64, protocol: str = "2pc",
             inline_trunc: bool = True) -> Ledger:
    """One secure elementwise multiply. `inline_trunc=True` prices the
    classic trunc-at-op-boundary stream (the CrypTen-style baselines);
    the executable scale-carrying ops emit the RAW product
    (`inline_trunc=False`) and `proxy_exec_cost` places the forced
    truncations where `mpc/scale.py` actually fires them."""
    if protocol in _P3:
        led = _led(CostRecord(op, 1, 3 * ring.elem_bytes * n, n,
                              6 * n, "bw"))
    elif protocol == "spdz2pc":
        # MAC'd triple + sacrificed triple (offline), the 1-round
        # sacrifice correlation open, then the Beaver open — in the
        # exact order spdz2pc.mul records them
        led = _led(_offline_mac(3 * n, op + ".triple", ring),
                   _offline_mac(3 * n, op + ".sacrifice_triple", ring),
                   CostRecord(op + ".sacrifice", 1,
                              4 * ring.elem_bytes * n, n, 0, "bw"),
                   CostRecord(op, 1, 4 * ring.elem_bytes * n, n,
                              4 * n, "bw"))
    else:
        led = _led(_offline(3 * n, op + ".triple", ring),
                   CostRecord(op, 1, 4 * ring.elem_bytes * n, n,
                              4 * n, "bw"))
    if inline_trunc:
        led = merge(led, trunc_cost(n, op + ".trunc", ring=ring,
                                    protocol=protocol))
    return led


def matmul_cost(batch: int, m: int, k: int, n: int,
                op: str = "beaver_matmul", *,
                ring: RingSpec = RING64, protocol: str = "2pc",
                inline_trunc: bool = True) -> Ledger:
    if protocol in _P3:
        # resharing flight of the OUTPUT: bytes ~ batch*m*n (the inverse
        # of Beaver's input-proportional wire profile)
        out_elems = batch * m * n
        led = _led(CostRecord(op, 1, 3 * ring.elem_bytes * out_elems,
                              out_elems, 6 * batch * m * k * n, "bw"))
    elif protocol == "spdz2pc":
        in_elems = batch * (m * k + k * n)
        trip = in_elems + batch * m * n
        led = _led(_offline_mac(trip, op + ".triple", ring),
                   _offline_mac(trip, op + ".sacrifice_triple", ring),
                   CostRecord(op + ".sacrifice", 1,
                              2 * ring.elem_bytes * in_elems, in_elems,
                              0, "bw"),
                   CostRecord(op, 1, 2 * ring.elem_bytes * in_elems,
                              in_elems, 2 * batch * m * k * n, "bw"))
    else:
        in_elems = batch * (m * k + k * n)
        nbytes = 2 * ring.elem_bytes * in_elems
        led = _led(_offline(in_elems + batch * m * n, op + ".triple",
                            ring),
                   CostRecord(op, 1, nbytes, in_elems,
                              2 * batch * m * k * n, "bw"))
    if inline_trunc:
        led = merge(led, trunc_cost(batch * m * n, op + ".trunc",
                                    ring=ring, protocol=protocol))
    return led


def cmp_cost(n: int, op: str = "secure_cmp") -> Ledger:
    return _led(CostRecord(op, CMP_ROUNDS, CMP_BYTES * n, n, 0, "lat"))


def relu_cost(n: int, op: str = "relu", *, ring: RingSpec = RING64,
              protocol: str = "2pc") -> Ledger:
    return merge(cmp_cost(n, op + ".cmp"),
                 mul_cost(n, op + ".mul", ring=ring, protocol=protocol))


def exp_cost(n: int, op: str = "exp") -> Ledger:
    led = Ledger()
    for rec in [CostRecord(op, 1, 4 * EB * n, n, 4 * n, "bw")] * EXP_ITERS:
        led.add(rec)
    return led


def reciprocal_cost(n: int, op: str = "reciprocal") -> Ledger:
    led = exp_cost(n, op + ".exp_init")
    for _ in range(RECIP_ITERS):
        led.records.extend(mul_cost(n, op + ".nr").records * 2)
    return led


def rsqrt_cost(n: int, op: str = "rsqrt") -> Ledger:
    led = exp_cost(n, op + ".exp_init")
    for _ in range(RSQRT_ITERS):
        led.records.extend(mul_cost(n, op + ".nr").records * 3)
    return led


def log_cost(n: int, op: str = "log") -> Ledger:
    led = Ledger()
    for _ in range(LOG_ITERS):
        led.records.extend(exp_cost(n, op + ".hh_exp").records)
        led.records.extend(mul_cost(n, op + ".hh_mul").records)
    return led


def max_cost(rows: int, d: int, op: str = "max") -> Ledger:
    """Tournament max: log2(d) sequential levels of (compare + select-mul)."""
    led = Ledger()
    levels = max(1, math.ceil(math.log2(max(d, 2))))
    width = d
    for _ in range(levels):
        half = width // 2
        if half == 0:
            break
        led.records.extend(cmp_cost(rows * half, op + ".cmp").records)
        led.records.extend(mul_cost(rows * half, op + ".sel").records)
        width = width - half
    return led


def softmax_cost(rows: int, d: int, op: str = "softmax") -> Ledger:
    return merge(max_cost(rows, d, op + ".max"),
                 exp_cost(rows * d, op + ".exp"),
                 reciprocal_cost(rows, op + ".recip"),
                 mul_cost(rows * d, op + ".norm"))


def layernorm_cost(rows: int, d: int, op: str = "layernorm") -> Ledger:
    return merge(mul_cost(rows * d, op + ".var"),
                 rsqrt_cost(rows, op + ".rsqrt"),
                 mul_cost(rows * d, op + ".normmul"),
                 mul_cost(rows * d, op + ".affine"))


def gelu_cost(n: int, op: str = "gelu") -> Ledger:
    return merge(mul_cost(n, op + ".sq"), mul_cost(n, op + ".mul"))


def entropy_cost(rows: int, classes: int, op: str = "entropy") -> Ledger:
    return merge(softmax_cost(rows, classes, op + ".softmax"),
                 log_cost(rows * classes, op + ".log"),
                 mul_cost(rows * classes, op + ".plogp"))


# ---------------------------------------------------------------------------
# MLP emulator costs (the paper's technique)
# ---------------------------------------------------------------------------

def mlp_cost(rows: int, d_in: int, hidden: int, d_out: int,
             op: str = "mlp", *, ring: RingSpec = RING64,
             protocol: str = "2pc") -> Ledger:
    """Linear(d_in->h) + ReLU(h) + Linear(h->d_out), private weights."""
    return merge(matmul_cost(1, rows, d_in, hidden, op + ".fc1", ring=ring,
                             protocol=protocol),
                 relu_cost(rows * hidden, op + ".relu", ring=ring,
                           protocol=protocol),
                 matmul_cost(1, rows, hidden, d_out, op + ".fc2", ring=ring,
                             protocol=protocol))


# ---------------------------------------------------------------------------
# block / model / selection costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockGeom:
    batch: int
    seq: int
    d_model: int
    heads: int
    d_head: int
    d_ff: int

    @property
    def tokens(self) -> int:
        return self.batch * self.seq


def exact_attention_cost(g: BlockGeom) -> Ledger:
    """One exact transformer block forward under CrypTen (the baseline)."""
    t = g.tokens
    dh = g.d_head
    return merge(
        matmul_cost(1, t, g.d_model, 3 * g.heads * dh, "attn.qkv"),
        matmul_cost(g.batch * g.heads, g.seq, dh, g.seq, "attn.scores"),
        softmax_cost(g.batch * g.heads * g.seq, g.seq, "attn.softmax"),
        matmul_cost(g.batch * g.heads, g.seq, g.seq, dh, "attn.av"),
        matmul_cost(1, t, g.heads * dh, g.d_model, "attn.out"),
        layernorm_cost(t, g.d_model, "attn.ln"),
    )


def exact_ffn_cost(g: BlockGeom) -> Ledger:
    t = g.tokens
    return merge(
        matmul_cost(1, t, g.d_model, g.d_ff, "ffn.fc1"),
        gelu_cost(t * g.d_ff, "ffn.gelu"),
        matmul_cost(1, t, g.d_ff, g.d_model, "ffn.fc2"),
        layernorm_cost(t, g.d_model, "ffn.ln"),
    )


def exact_block_cost(g: BlockGeom) -> Ledger:
    return merge(exact_attention_cost(g), exact_ffn_cost(g))


def exact_model_cost(g: BlockGeom, layers: int, classes: int) -> Ledger:
    led = Ledger()
    blk = exact_block_cost(g)
    for _ in range(layers):
        led.records.extend(blk.records)
    led.records.extend(matmul_cost(1, g.batch, g.d_model, classes, "head").records)
    led.records.extend(entropy_cost(g.batch, classes).records)
    return led


def proxy_block_cost(g: BlockGeom, mlp_hidden: int) -> Ledger:
    """SelectFormer proxy block: MLP_sm for softmax, MLP_ln for the
    LayerNorm reciprocal, no FFN, GeLU->ReLU (no GeLU at all w/o FFN)."""
    t = g.tokens
    dh = g.d_head
    rows_sm = g.batch * g.heads * g.seq
    return merge(
        matmul_cost(1, t, g.d_model, 3 * g.heads * dh, "proxy.qkv"),
        matmul_cost(g.batch * g.heads, g.seq, dh, g.seq, "proxy.scores"),
        mlp_cost(rows_sm, g.seq, mlp_hidden, g.seq, "proxy.mlp_sm"),
        matmul_cost(g.batch * g.heads, g.seq, g.seq, dh, "proxy.av"),
        matmul_cost(1, t, g.heads * dh, g.d_model, "proxy.out"),
        # LayerNorm: numerator local; reciprocal-of-std emulated by MLP
        mul_cost(t * g.d_model, "proxy.ln.var"),
        mlp_cost(t, 1, mlp_hidden, 1, "proxy.mlp_ln"),
        mul_cost(t * g.d_model, "proxy.ln.normmul"),
    )


def proxy_model_cost(g: BlockGeom, layers: int, classes: int,
                     mlp_hidden: int) -> Ledger:
    led = Ledger()
    blk = proxy_block_cost(g, mlp_hidden)
    for _ in range(layers):
        led.records.extend(blk.records)
    led.records.extend(matmul_cost(1, g.batch, g.d_model, classes,
                                   "proxy.head").records)
    # fused softmax+entropy MLP: classes -> hidden -> 1
    led.records.extend(mlp_cost(g.batch, classes, mlp_hidden, 1,
                                "proxy.mlp_se").records)
    return led


def proxy_exec_cost(bsz: int, seq: int, d_model: int, heads: int,
                    kv_heads: int, d_head: int, mlp_hidden: int,
                    classes: int, n_layers: int,
                    op: str = "exec", *, ring: RingSpec = RING64,
                    protocol: str = "2pc", fused: bool = False) -> Ledger:
    """EXACT mirror of the engine forward's share-level op stream.

    Record-for-record prediction of what one batch of the executable
    proxy forward (`engine/forward.proxy_entropy` under an MPCEngine)
    puts on the wire — the contract the wave executor's TraceEngine
    probe (engine/trace.py) is held to, and the per-batch input that
    iosched.makespan schedules. Unlike `proxy_model_cost`
    (paper-geometry pricing with fused QKV), this follows the executed
    path: separate q/k/v openings, two LayerNorm affine multiplies, GQA
    head grouping, and ring-dependent truncation — record-free local
    shifts on RING64, dealer-assisted `trunc_open` rounds on RING32
    (including the mean/scale `mul_public` truncations that are free on
    RING64). Biases add no wire cost, so the formulas hold with or
    without them.

    `protocol="3pc"` mirrors the replicated-sharing stream: resharing
    flights (output-proportional bytes) in place of Beaver openings,
    0-round `trunc_reshare` bytes wherever a truncation is forced (the
    re-replication component riding the resharing flight), and an
    empty offline channel on both rings. `protocol="spdz2pc"` mirrors
    the malicious tier (doubled MAC'd offline bytes, a sacrifice flight
    per multiply, dealer truncation on both rings, and the boundary
    mac_key/mac_check tail); `protocol="aby3trunc"` swaps every forced
    truncation for the 2-round exact `trunc2` record.

    `fused=True` mirrors the round-compressed stream instead: the eager
    event stream below — with GroupBegin/GroupEnd markers placed exactly
    where `engine/forward.py` opens its `eng.fused` groups — is replayed
    through `fusion.compress_events`, i.e. the very FlightBatcher the
    executed path batches with, so flush semantics cannot drift between
    model and execution.

    The stream is SCALE-SIMULATED: multiplies emit raw products at the
    summed exponent (`inline_trunc=False`) and forced truncations land
    exactly where the `mpc/scale.py` lattice — the SAME decision
    procedure the executable ops consult — fires them: power-of-two
    rescales (pow2 means, `d_head**-0.5`) fold for free, comparison
    bits multiply at exponent 0 (ReLU is truncation-free), a tensor
    consumed by several scale-sensitive ops truncates once (the
    ops.force memo), and forcing a broadcast bills the pre-broadcast
    element count (layout lineage). That is the cross-op deferred-
    truncation contract this mirror certifies record-for-record.
    """
    from repro_torch.mpc import fusion, protocols, scale as lattice

    f = ring.frac_bits
    # headroom-cap bits handed to the scale lattice: mirrors
    # ops._headroom_bits — only exact-trunc backends (spdz2pc,
    # aby3trunc) may defer to the ring-wide 3f cap; probabilistic
    # local-trunc backends keep 2f (bits=None)
    hbits = ring.bits if protocols.get(protocol).exact_trunc else None
    w, wk = heads, min(kv_heads, heads)
    t = bsz * seq
    events: list = []
    kw = dict(ring=ring, protocol=protocol)

    def ext(led: Ledger) -> None:
        events.extend(led.records)

    class V:
        """Symbolic scale-carrying tensor: carried exponent, the element
        count a forced truncation bills (its lineage ROOT's numel), and
        the per-target force memo mirroring ops.force's cache."""

        def __init__(self, fb: int, n: int):
            self.fb, self.n, self.forced = fb, n, set()

    W = V(f, 0)                       # shared weights: always canonical

    def forced(v: V, name: str, to: int) -> None:
        if v.fb <= to or to in v.forced:
            return
        ext(trunc_cost(v.n, f"{op}.{name}", **kw))
        v.forced.add(to)

    def mul_pub(v: V, c: float, name: str, n_out: int) -> V:
        k = lattice.pow2_exponent(c)
        if k is not None:             # free exponent fold
            return V(v.fb - k, n_out)
        _, shift, out_fb = lattice.mul_public_plan(v.fb, c, f, hbits)
        if shift:
            forced(v, name, v.fb - shift)
        return V(out_fb, n_out)

    def mul2(x: V, y: V, name: str, n: int) -> V:
        px, py, out_fb = lattice.mul_plan(x.fb, y.fb, f, hbits)
        if px:
            forced(x, f"{name}.x", x.fb - px)
        if py and y is not x:
            forced(y, f"{name}.y", y.fb - py)
        ext(mul_cost(n, f"{op}.{name}", inline_trunc=False, **kw))
        return V(out_fb, n)

    def mm(x: V, y: V, name: str, batch: int, m: int, kk: int,
           n: int) -> V:
        px, py, out_fb = lattice.mul_plan(x.fb, y.fb, f, hbits)
        if px:
            forced(x, f"{name}.x", x.fb - px)
        if py and y is not x:
            forced(y, f"{name}.y", y.fb - py)
        ext(matmul_cost(batch, m, kk, n, f"{op}.{name}",
                        inline_trunc=False, **kw))
        return V(out_fb, batch * m * n)

    def mlp(x: V, rows: int, d_in: int, hid: int, d_out: int,
            name: str) -> V:
        h = mm(x, W, f"{name}.fc1", 1, rows, d_in, hid)
        # ReLU: comparison (scale-invariant) + bit multiply at exponent
        # 0 — truncation-free, output keeps h's exponent
        ext(cmp_cost(rows * hid, f"{op}.{name}.relu.cmp"))
        r = mul2(h, V(0, rows * hid), f"{name}.relu.mul", rows * hid)
        return mm(r, W, f"{name}.fc2", 1, rows, hid, d_out)

    x_fb = f                          # shared activations enter canonical
    for _ in range(n_layers):
        # MLP-LayerNorm: pow2 d folds the mean for free; the centered
        # activation truncates ONCE (memo) though both the variance
        # square and the normalize multiply consume it
        events.append(fusion.GroupBegin("ln_stats"))
        mu = mul_pub(V(x_fb, t), 1.0 / d_model, "ln.mu.force", t)
        # centering sub: exact lift unless mu's pow2 fold topped the 2f
        # cap (layer >= 2, pow2 d) — then mu down-truncs KEYED, billed
        # at its pre-broadcast rows (lineage)
        align_fb = lattice.align_target(x_fb, mu.fb, f, hbits)
        if mu.fb > align_fb:
            forced(mu, "ln.mu.align", align_fb)
        xc = V(align_fb, t * d_model)
        var_p = mul2(xc, xc, "ln.var", t * d_model)
        var = mul_pub(V(var_p.fb, t), 1.0 / d_model, "ln.var_mean.force", t)
        events.append(fusion.GROUP_END)
        inv = mlp(var, t, 1, mlp_hidden, 1, "mlp_ln")
        # normalize: inv's force bills its pre-broadcast rows (lineage)
        h = mul2(xc, inv, "ln.normmul", t * d_model)
        h = mul2(h, W, "ln.affine", t * d_model)
        ha = V(h.fb, t * d_model)     # + beta (lift, free): new object
        # pruned attention: per-projection secure matmuls; one forced
        # trunc of the shared input serves all three projections
        events.append(fusion.GroupBegin("qkv"))
        q = mm(ha, W, "q", 1, t, d_model, w * d_head)
        k_ = mm(ha, W, "k", 1, t, d_model, wk * d_head)
        v_ = mm(ha, W, "v", 1, t, d_model, wk * d_head)
        events.append(fusion.GROUP_END)
        scores = mm(q, k_, "scores", bsz * w, seq, d_head, seq)
        scores = mul_pub(scores, d_head ** -0.5, "scores.scale.force",
                         bsz * w * seq * seq)
        probs = mlp(scores, bsz * w * seq, seq, mlp_hidden, seq, "mlp_sm")
        o = mm(probs, v_, "av", bsz * w, seq, seq, d_head)
        out = mm(o, W, "out", 1, t, w * d_head, d_model)
        x_fb = lattice.align_target(x_fb, out.fb, f, hbits)  # residual
    pooled = mul_pub(V(x_fb, bsz * d_model), 1.0 / seq, "pool.force",
                     bsz * d_model)
    logits = mm(pooled, W, "head", 1, bsz, d_model, classes)
    ent = mlp(logits, bsz, classes, mlp_hidden, 1, "mlp_se")
    # the engine's entropy head forces its output canonical — the
    # forward's public boundary (QuickSelect consumes fb == frac_bits)
    forced(ent, "entropy.force", f)
    if protocol == "spdz2pc":
        # the malicious boundary: dealer MAC-key shipment + ONE batched
        # MAC check for every partial open of the forward (constant
        # size), in the order spdz2pc.mac_check_flight records them
        events.append(CostRecord(f"{op}.mac_key", 0, 2 * ring.elem_bytes,
                                 1, 0, "offline"))
        events.append(CostRecord(f"{op}.mac_check", 1,
                                 4 * ring.elem_bytes, 1, 0, "bw"))
    if fused:
        return fusion.compress_events(events)
    led = Ledger()
    led.records.extend(r for r in events
                       if not isinstance(r, (fusion.GroupBegin,
                                             fusion.GroupEnd)))
    return led


def pr4_trunc_baseline(bsz: int, seq: int, d_model: int, heads: int,
                       kv_heads: int, d_head: int, mlp_hidden: int,
                       classes: int, n_layers: int, *,
                       ring: RingSpec = RING64) -> tuple[int, int]:
    """FROZEN eager-truncation baseline (the JAX package's name for it):
    (truncation events, dealer trunc-pair bytes) of the pre-scale-
    carrying RING32 2PC proxy stream, where every mul/matmul/mul_public/
    mean forced its own truncation at the op boundary (18 events per
    layer + 5 tail). This is the regression reference the JAX package's
    `benchmarks/bench_fusion.py --smoke` gates the >=25% event reduction
    against — do NOT update it to track the live stream."""
    w, wk = heads, min(kv_heads, heads)
    t = bsz * seq
    rows = bsz * w * seq
    per_layer = [
        t,                      # mean trunc
        t * d_model,            # var mul
        t,                      # var mean
        t * mlp_hidden,         # mlp_ln fc1
        t * mlp_hidden,         # mlp_ln relu mul
        t,                      # mlp_ln fc2
        t * d_model,            # normmul
        t * d_model,            # affine
        t * w * d_head,         # q
        t * wk * d_head,        # k
        t * wk * d_head,        # v
        bsz * w * seq * seq,    # scores matmul
        bsz * w * seq * seq,    # scores scale
        rows * mlp_hidden,      # mlp_sm fc1
        rows * mlp_hidden,      # mlp_sm relu mul
        rows * seq,             # mlp_sm fc2
        bsz * w * seq * d_head,  # av
        t * d_model,            # out
    ]
    tail = [bsz * d_model, bsz * classes, bsz * mlp_hidden,
            bsz * mlp_hidden, bsz]
    numels = per_layer * n_layers + tail
    # one dealer pair per event: (r, r>>f) = 2 tensors, both parties
    return len(numels), sum(4 * ring.elem_bytes * n for n in numels)


def mpcformer_block_cost(g: BlockGeom) -> Ledger:
    """MPCFormer baseline block: "2Quad" softmax (exp->(x+c)^2, recip stays),
    quad GeLU, keeps FFN and full dims — no dimension reduction."""
    t = g.tokens
    dh = g.d_head
    rows = g.batch * g.heads * g.seq
    quad_softmax = merge(mul_cost(rows * g.seq, "mf.sm.sq"),
                         reciprocal_cost(rows, "mf.sm.recip"),
                         mul_cost(rows * g.seq, "mf.sm.norm"))
    return merge(
        matmul_cost(1, t, g.d_model, 3 * g.heads * dh, "mf.qkv"),
        matmul_cost(g.batch * g.heads, g.seq, dh, g.seq, "mf.scores"),
        quad_softmax,
        matmul_cost(g.batch * g.heads, g.seq, g.seq, dh, "mf.av"),
        matmul_cost(1, t, g.heads * dh, g.d_model, "mf.out"),
        layernorm_cost(t, g.d_model, "mf.ln1"),
        matmul_cost(1, t, g.d_model, g.d_ff, "mf.fc1"),
        gelu_cost(t * g.d_ff, "mf.gelu"),
        matmul_cost(1, t, g.d_ff, g.d_model, "mf.fc2"),
        layernorm_cost(t, g.d_model, "mf.ln2"),
    )


def selection_phase_cost(n_candidates: int, keep: int, g: BlockGeom,
                         layers: int, classes: int, mlp_hidden: int) -> Ledger:
    """One multi-phase selection phase: score every candidate with the
    proxy, then QuickSelect the top `keep` (batched comparisons)."""
    n_batches = math.ceil(n_candidates / g.batch)
    fwd = proxy_model_cost(g, layers, classes, mlp_hidden)
    led = fwd.scaled(n_batches)
    # quickselect: ~2n comparisons in ~log(n) coalesced flights
    n_cmp = int(2.0 * n_candidates)
    flights = max(1, math.ceil(math.log2(max(n_candidates, 2)))) + 4
    led.add(CostRecord("quickselect", flights * CMP_ROUNDS,
                       n_cmp * CMP_BYTES, n_cmp, 0, "lat"))
    return led


def oracle_selection_cost(n_candidates: int, keep: int, g: BlockGeom,
                          layers: int, classes: int) -> Ledger:
    n_batches = math.ceil(n_candidates / g.batch)
    led = exact_model_cost(g, layers, classes).scaled(n_batches)
    n_cmp = int(2.0 * n_candidates)
    flights = max(1, math.ceil(math.log2(max(n_candidates, 2)))) + 4
    led.add(CostRecord("quickselect", flights * CMP_ROUNDS,
                       n_cmp * CMP_BYTES, n_cmp, 0, "lat"))
    return led
