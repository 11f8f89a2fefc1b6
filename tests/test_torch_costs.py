"""The port's analytic cost mirror (`mpc/costs.py`) against the JAX
package's, and against the port's own meta probe.

  * every public function of `costs`, over a grid of arguments, on both
    rings and (where the formula takes one) every protocol: the same
    ledger record for record (op, rounds, bytes, numel, flops, tag);
  * `proxy_exec_cost` equal to the TraceEngine probe of the executed
    forward (engine/trace.py), eager and fused, on both rings, at
    tests/test_engine.py's geometry and at BERT-base width (d_model 768,
    12 heads of 64, seq 512, batch 4, the two chip_smoke.py proxies);
  * `proxy_exec_cost` for each of the other three protocols (3pc,
    spdz2pc, aby3trunc), now registered, equal to the JAX package's
    record for record, eager and fused.
"""
import dataclasses
import itertools

import pytest

from repro.mpc import costs as j_costs
from repro.mpc.ring import RING32 as J_RING32, RING64 as J_RING64
from repro_torch.configs.paper_targets import BERT, TINY_TARGET
from repro_torch.core.proxy import ProxySpec
from repro_torch.engine import cached_probe
from repro_torch.mpc import costs
from repro_torch.mpc.ring import RING32, RING64

RINGS = {"ring32": (J_RING32, RING32), "ring64": (J_RING64, RING64)}
PROTOCOLS = ("2pc", "3pc", "spdz2pc", "aby3trunc")


def recs(led):
    return [(r.op, r.rounds, r.nbytes, r.numel, r.flops, r.tag, r.wave)
            for r in led.records]


def stream(led):
    """What the probe and the mirror share: op names differ (the mirror
    names its sites), the numbers may not."""
    return [(r.rounds, r.nbytes, r.numel, r.flops, r.tag) for r in
            led.records]


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_protocol_primitives(ring, protocol):
    jr, pr = RINGS[ring]
    for n in (1, 7, 4096):
        for jf, pf in ((j_costs.open_cost, costs.open_cost),
                       (j_costs.trunc_cost, costs.trunc_cost),
                       (j_costs.relu_cost, costs.relu_cost)):
            assert recs(pf(n, ring=pr, protocol=protocol)) == \
                recs(jf(n, ring=jr, protocol=protocol))
        for inline in (True, False):
            assert recs(costs.mul_cost(n, ring=pr, protocol=protocol,
                                       inline_trunc=inline)) == \
                recs(j_costs.mul_cost(n, ring=jr, protocol=protocol,
                                      inline_trunc=inline))
    for b, m, k, n in ((1, 3, 5, 7), (12, 512, 64, 512), (1, 2048, 768, 16)):
        for inline in (True, False):
            assert recs(costs.matmul_cost(b, m, k, n, ring=pr,
                                          protocol=protocol,
                                          inline_trunc=inline)) == \
                recs(j_costs.matmul_cost(b, m, k, n, ring=jr,
                                         protocol=protocol,
                                         inline_trunc=inline))
    for rows, d_in, hid, d_out in ((4, 2, 2, 1), (24576, 512, 16, 512)):
        assert recs(costs.mlp_cost(rows, d_in, hid, d_out, ring=pr,
                                   protocol=protocol)) == \
            recs(j_costs.mlp_cost(rows, d_in, hid, d_out, ring=jr,
                                  protocol=protocol))


@pytest.mark.parametrize("n", [1, 5, 6144])
def test_nonlinear_formulas(n):
    for name in ("cmp_cost", "exp_cost", "reciprocal_cost", "rsqrt_cost",
                 "log_cost", "gelu_cost"):
        assert recs(getattr(costs, name)(n)) == \
            recs(getattr(j_costs, name)(n)), name
    for rows, d in ((1, 1), (3, 2), (5, 7), (48, 512)):
        for name in ("max_cost", "softmax_cost", "layernorm_cost",
                     "entropy_cost"):
            assert recs(getattr(costs, name)(rows, d)) == \
                recs(getattr(j_costs, name)(rows, d)), name
    assert costs.EB == j_costs.EB


GEOMS = [(8, 128, 768, 12, 64, 3072), (4, 512, 768, 12, 64, 3072),
         (6, 8, 32, 2, 16, 64), (8, 128, 768, 1, 64, 0)]


@pytest.mark.parametrize("geom", GEOMS)
def test_block_model_and_selection_formulas(geom):
    g, jg = costs.BlockGeom(*geom), j_costs.BlockGeom(*geom)
    assert g.tokens == jg.tokens
    for name in ("exact_attention_cost", "exact_ffn_cost",
                 "exact_block_cost", "mpcformer_block_cost"):
        assert recs(getattr(costs, name)(g)) == \
            recs(getattr(j_costs, name)(jg)), name
    for layers, classes, hid in ((1, 2, 2), (3, 2, 16), (12, 4, 8)):
        assert recs(costs.exact_model_cost(g, layers, classes)) == \
            recs(j_costs.exact_model_cost(jg, layers, classes))
        assert recs(costs.proxy_block_cost(g, hid)) == \
            recs(j_costs.proxy_block_cost(jg, hid))
        assert recs(costs.proxy_model_cost(g, layers, classes, hid)) == \
            recs(j_costs.proxy_model_cost(jg, layers, classes, hid))
        for n_cand, keep in ((42_000, 12_600), (800, 160), (3, 1)):
            assert recs(costs.selection_phase_cost(
                n_cand, keep, g, layers, classes, hid)) == \
                recs(j_costs.selection_phase_cost(n_cand, keep, jg, layers,
                                                  classes, hid))
            assert recs(costs.oracle_selection_cost(
                n_cand, keep, g, layers, classes)) == \
                recs(j_costs.oracle_selection_cost(n_cand, keep, jg, layers,
                                                   classes))


def test_merge():
    a, b = costs.mul_cost(3), costs.cmp_cost(5)
    ja, jb = j_costs.mul_cost(3), j_costs.cmp_cost(5)
    assert recs(costs.merge(a, b, a)) == recs(j_costs.merge(ja, jb, ja))
    assert recs(costs.merge()) == recs(j_costs.merge()) == []


# the mirror's arguments: (bsz, seq, d_model, heads, kv_heads, d_head,
# mlp_hidden, classes, n_layers)
EXEC_ARGS = list(itertools.product(
    [(6, 8, 32, 2, 2, 16, 4, 3, 1), (8, 8, 32, 2, 1, 16, 4, 2, 2),
     (4, 512, 768, 1, 12, 64, 2, 2, 1), (4, 512, 768, 12, 12, 64, 16, 2, 3),
     (2, 16, 64, 4, 2, 16, 8, 4, 3)],
    [False, True]))


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("args,fused", EXEC_ARGS)
def test_proxy_exec_cost_matches_jax(ring, args, fused):
    jr, pr = RINGS[ring]
    assert recs(costs.proxy_exec_cost(*args, ring=pr, fused=fused)) == \
        recs(j_costs.proxy_exec_cost(*args, ring=jr, fused=fused))
    assert costs.pr4_trunc_baseline(*args, ring=pr) == \
        j_costs.pr4_trunc_baseline(*args, ring=jr)


TEST_ENGINE = dataclasses.replace(TINY_TARGET, vocab_size=64, n_layers=1,
                                  d_model=32, n_heads=2, n_kv_heads=2,
                                  d_head=16, d_ff=64)
PROBES = [(TEST_ENGINE, ProxySpec(1, 2, 4), 6, 8, 3),
          (BERT, ProxySpec(1, 1, 2), 4, 512, 2),
          (BERT, ProxySpec(3, 12, 16), 4, 512, 2)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("cfg,spec,batch,seq,classes", PROBES)
def test_proxy_exec_cost_equals_meta_probe(cfg, spec, batch, seq, classes,
                                           ring, fused):
    pr = RINGS[ring][1]
    probe = cached_probe(cfg, spec, batch=batch, seq=seq, classes=classes,
                         ring=pr, fused=fused)
    mirror = costs.proxy_exec_cost(batch, seq, cfg.d_model, spec.n_heads,
                                   cfg.n_kv_heads, cfg.d_head, spec.mlp_dim,
                                   classes, spec.n_layers, ring=pr,
                                   fused=fused)
    assert stream(probe) == stream(mirror)


@pytest.mark.parametrize("protocol", ["3pc", "spdz2pc", "aby3trunc"])
def test_unported_protocols_raise_in_the_mirror(protocol):
    """Once refused, now ported: the mirror of each backend equals the
    JAX package's record for record, on both rings, eager and fused."""
    for ring in sorted(RINGS):
        jr, tr = RINGS[ring]
        for fused in (False, True):
            want = j_costs.proxy_exec_cost(6, 8, 32, 2, 2, 16, 4, 3, 1,
                                           ring=jr, protocol=protocol,
                                           fused=fused)
            got = costs.proxy_exec_cost(6, 8, 32, 2, 2, 16, 4, 3, 1,
                                        ring=tr, protocol=protocol,
                                        fused=fused)
            assert want.records and recs(got) == recs(want), (ring, fused)
