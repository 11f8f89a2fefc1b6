"""The port's token-serving path against the JAX package's, on the CPU:
`configs` (the two ported zoo configs), `models.transformer`'s ssm and
hybrid families (forward_logits, prefill, decode_step, init_cache) and
`launch.serve.Server`, at the smoke configs.

Weights are built by the JAX package from a seed and carried across with
`core.tree.to_device`; tokens come from numpy. Tolerances: the largest
logit error within 1e-4 of max |JAX| at `dtype="float32"`, 2e-2 (absolute,
tests/test_models.py's tolerance) at the configs' bfloat16 activations.

The JAX `Server` is run with its sharding rules switched off
(`rules_scope` patched to a no-op context): under the installed jax its
`with_sharding_constraint` on a one-device mesh of Explicit axes raises
(ROADMAP Queue 3); on one device the rules are the identity anyway.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.models import transformer as j_T
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import transformer as T

ARCHS = ["mamba2_2_7b", "recurrentgemma_2b"]
F32_TOL, BF16_TOL = 1e-4, 2e-2


def cfgs(arch, dtype):
    j_cfg = dataclasses.replace(j_base.load_arch(arch, smoke=True),
                                dtype=dtype)
    cfg = dataclasses.replace(base.load_arch(arch, smoke=True), dtype=dtype)
    return j_cfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def weights(arch):
    j_cfg = j_base.load_arch(arch, smoke=True)
    jp = j_T.init_params(jax.random.key(0), j_cfg)
    return jp, tree.to_device(jax.tree.map(np.asarray, jp), "cpu")


def tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def assert_logits_close(got, want, dtype):
    got = np.asarray(got.float())
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        assert err <= F32_TOL * float(np.abs(want).max()), err
    else:
        assert err < BF16_TOL, err


def test_configs_match_jax():
    """Every id of the JAX package's zoo, in its order, full and smoke;
    an unknown id raises."""
    assert base.ARCH_IDS == j_base.ARCH_IDS
    for arch in base.ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(base.load_arch(arch, smoke)) == \
                dataclasses.asdict(j_base.load_arch(arch, smoke))
    with pytest.raises(ValueError, match="unknown"):
        base.load_arch("llama_7b")


def test_carried_tree_matches_port_init(arch, weights):
    """A JAX-built smoke tree carried across has exactly the keys and
    shapes of the port's own init_params."""
    _, cfg = cfgs(arch, "bfloat16")
    own = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")

    def shapes(tr, path=()):
        if isinstance(tr, dict):
            return {k: v for key, sub in tr.items()
                    for k, v in shapes(sub, path + (key,)).items()}
        return {path: tuple(tr.shape)}
    assert shapes(weights[1]) == shapes(own)
    assert all(x.dtype == torch.float32 for x in tree.tree_leaves(own))


@pytest.mark.parametrize("dtype,seq", [("float32", 32), ("bfloat16", 16)])
def test_forward_logits_matches_jax(arch, weights, dtype, seq):
    """bfloat16 runs at the geometry where tests/test_models.py set its
    2e-2 (batch 2, seq 16). Two bfloat16 forwards of the RecurrentGemma
    smoke config at seq 32 differ by 0.023 (the JAX package's own
    bfloat16 logits are 0.021 from its float32 ones there), so float32
    carries the longer sequence, past the window of 16."""
    j_cfg, cfg = cfgs(arch, dtype)
    tok = tokens(1, 2, seq)
    got, _ = T.forward_logits(weights[1], cfg, {"tokens": tok})
    want, _ = j_T.forward_logits(weights[0], j_cfg,
                                 {"tokens": jnp.asarray(tok)})
    assert_logits_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, weights, dtype):
    """prefill then three decode steps, logits and caches, against the
    JAX package at a prompt as long as the smoke window (16), where its
    window cache is right."""
    j_cfg, cfg = cfgs(arch, dtype)
    s, steps = 16, 3
    tok = tokens(2, 2, s + steps)
    lg, cache = T.prefill(weights[1], cfg, {"tokens": tok[:, :s]},
                          max_len=s + 8)
    j_lg, j_cache = j_T.prefill(weights[0], j_cfg,
                                {"tokens": jnp.asarray(tok[:, :s])},
                                max_len=s + 8)
    assert_logits_close(lg, j_lg, dtype)
    assert set(cache) == set(j_cache)
    for k in cache:
        assert tuple(cache[k].shape) == j_cache[k].shape, k
    for j in range(steps):
        step = {"tokens": tok[:, s + j:s + j + 1]}
        lg, cache = T.decode_step(weights[1], cfg, cache, step, s + j)
        j_lg, j_cache = j_T.decode_step(
            weights[0], j_cfg, j_cache,
            {"tokens": jnp.asarray(step["tokens"])}, jnp.int32(s + j))
        assert_logits_close(lg, j_lg, dtype)
    if dtype == "float32":
        for k in cache:
            want = np.asarray(j_cache[k], np.float32)
            err = float(np.abs(cache[k].float().numpy() - want).max())
            assert err <= F32_TOL * max(1.0, float(np.abs(want).max())), k


def test_init_cache_matches_jax(arch):
    j_cfg, cfg = cfgs(arch, "bfloat16")
    got = T.init_cache(cfg, 3, 40, "cpu")
    want = j_T.init_cache(j_cfg, 3, 40)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_short_prompt_decode_matches_teacher_forcing(weights, arch):
    """A RecurrentGemma prompt shorter than the window: the port's decode
    matches teacher-forced forward_logits. It is not compared with the
    JAX package's decode_step here: that prefill keeps a window cache of
    only S slots when S < w (transformer.py:688-692), so its decode then
    overwrites the first prompt token and forgets all but S tokens, and
    its logits drift from teacher forcing (ROADMAP Queue 3). The port
    pads the cache to w slots in ring order. Mamba-2 has no window and
    is held to the same bound."""
    _, cfg = cfgs(arch, "float32")
    s, steps = 8, 6
    tok = tokens(3, 2, s + steps)
    tf, _ = T.forward_logits(weights[1], cfg, {"tokens": tok})
    j_tf, _ = j_T.forward_logits(weights[0], cfgs(arch, "float32")[0],
                                 {"tokens": jnp.asarray(tok)})
    assert_logits_close(tf, j_tf, "float32")
    lg, cache = T.prefill(weights[1], cfg, {"tokens": tok[:, :s]},
                          max_len=s + steps)
    assert_logits_close(lg, j_tf[:, s - 1], "float32")
    for j in range(steps):
        lg, cache = T.decode_step(weights[1], cfg, cache,
                                  {"tokens": tok[:, s + j:s + j + 1]}, s + j)
        assert_logits_close(lg, j_tf[:, s + j], "float32")


def test_ring_cache_orders_slots_by_position():
    t = torch.arange(5.0).reshape(1, 5, 1, 1)
    assert T._ring_cache(t, 8)[0, :, 0, 0].tolist() == \
        [0, 1, 2, 3, 4, 0, 0, 0]
    # 7 tokens in a window of 4: positions 3..6 in slots 3, 0, 1, 2
    t = torch.arange(7.0).reshape(1, 7, 1, 1)
    assert T._ring_cache(t, 4)[0, :, 0, 0].tolist() == [4, 5, 6, 3]


@pytest.mark.parametrize("sq,window", [(40, 16), (37, 8), (16, 16),
                                       (24, 64)])
def test_attend_flash_local_matches_jax(sq, window):
    """The kernel front's "local" mask (flash_attn's causal window; its
    plain version on the CPU, the kernel on the card) against the JAX
    package's attend_full, grouped kv (10 heads over 2), windows narrower
    and wider than the sequence, within 1e-5 of max(1, max |want|)."""
    from repro.models import attention as j_att
    from repro_torch.models import attention
    rng = np.random.default_rng(sq + window)
    q = rng.standard_normal((2, sq, 10, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_att.attend_full(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_kind="local",
        window=window))
    got = attention.attend_flash(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), mask_kind="local",
                                 window=window).numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def test_flash_window_needs_causal_and_prefix_is_not_ported():
    """A window needs causal attention. The prefix mask is ported now:
    it runs (keys below the prefix kept, the rest causal), and with a
    window or without causal attention it raises; under grad it takes
    its backward (on the CPU the plain one), equal to autograd of the
    plain forward within 1e-5 of max |plain|."""
    from repro_torch.models import attention
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="window"):
        kops.flash_attn(q, q, q, causal=False, window=4)
    # (B, S, H, Dh) with q = 0: every kept key weighs the same, and v = I
    # reads the weights back
    q4 = torch.zeros(1, 8, 1, 16)
    v4 = torch.zeros(1, 8, 1, 16)
    v4[0, :, 0, :8] = torch.eye(8)
    o = attention.attend_flash(q4, q4, v4, mask_kind="prefix",
                               prefix_len=3)[0, :, 0]
    kept = (o[:, :8] > 0).int()
    want = (torch.arange(8)[None, :] <= torch.arange(8)[:, None]) \
        | (torch.arange(8)[None, :] < 3)
    assert torch.equal(kept, want.int())
    with pytest.raises(ValueError, match="prefix"):
        kops.flash_attn(q, q, q, causal=True, window=4, prefix_len=3)
    with pytest.raises(ValueError, match="prefix"):
        kops.flash_attn(q, q, q, causal=False, prefix_len=3)
    rng = np.random.default_rng(9)
    qg, kg, vg = (torch.tensor(rng.standard_normal((2, 8, 16)),
                               dtype=torch.float32, requires_grad=True)
                  for _ in range(3))
    do = torch.tensor(rng.standard_normal((2, 8, 16)), dtype=torch.float32)
    got = torch.autograd.grad(kops.flash_attn(qg, kg, vg, prefix_len=3),
                              (qg, kg, vg), do)
    want = torch.autograd.grad(ref.flash_attn(qg, kg, vg, prefix_len=3),
                               (qg, kg, vg), do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * max(
            1.0, float(w.abs().max()))


def _jax_server(monkeypatch, arch, max_len, max_new):
    monkeypatch.setattr(j_serve, "rules_scope",
                        lambda rules: contextlib.nullcontext())
    srv = j_serve.Server(j_serve.ServeConfig(arch=arch, max_len=max_len,
                                             max_new=max_new))
    srv.cfg = dataclasses.replace(srv.cfg, dtype="float32")
    return srv


@pytest.mark.parametrize("arch_lens", [("mamba2_2_7b", (4, 12)),
                                       ("mamba2_2_7b", (16, 17)),
                                       ("recurrentgemma_2b", (16, 21))])
def test_server_matches_jax_token_for_token(monkeypatch, arch_lens):
    """Server.run against the JAX Server at float32 smoke, the same weights
    and prompts: 6 requests on 4 slots (two prefill batches, left-padded
    prompts of mixed lengths). RecurrentGemma's prompts are no shorter
    than its window (16), where the JAX prefill's window cache is right."""
    arch, (lo, hi) = arch_lens
    j_srv = _jax_server(monkeypatch, arch, max_len=32, max_new=5)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=rng.integers(lo, hi + 1))
               for _ in range(6)]
    want = j_srv.run([j_serve.Request(i, p) for i, p in enumerate(prompts)])
    sc = serve.ServeConfig(arch=arch, max_len=32, max_new=5)
    srv = serve.Server(sc, device="cpu",
                       params=tree.to_device(
                           jax.tree.map(np.asarray, j_srv.params), "cpu"))
    srv.cfg = cfgs(arch, "float32")[1]
    got = srv.run([serve.Request(i, p) for i, p in enumerate(prompts)])
    assert got["outputs"] == want["outputs"]
    assert (got["requests"], got["tokens"]) == (want["requests"],
                                                want["tokens"]) == (6, 24)
    assert got["prefill_s"] > 0 and got["decode_s"] > 0


def test_server_on_the_cpu_takes_the_plain_versions():
    """The launch counters on the CPU: every prefill scan and attention
    takes the plain version, no kernel launches."""
    for reset in (kops.reset_ssd_stats, kops.reset_lru_stats,
                  kops.reset_fa_stats):
        reset()
    for arch in ARCHS:
        srv = serve.Server(serve.ServeConfig(arch=arch, max_len=24,
                                             max_new=2), device="cpu")
        rng = np.random.default_rng(0)
        srv.run([serve.Request(i, rng.integers(0, 256, 16))
                 for i in range(3)])
    assert kops.ssd_stats() == {"kernel": 0, "ref": 2}        # 2 layers
    assert kops.lru_stats() == {"kernel": 0, "ref": 4}        # 4 rec layers
    assert kops.fa_stats() == {"kernel": 0, "ref": 0}         # CPU: plain


def test_main_runs_and_appraise_is_not_ported(capsys, monkeypatch):
    serve.main(["--arch", "recurrentgemma_2b", "--device", "cpu",
                "--requests", "3", "--max-len", "24", "--max-new", "2"])
    assert "3 requests, 3 tokens" in capsys.readouterr().out
    # the appraisal service runs (tests/test_torch_appraisal.py), now
    # under every protocol: `--appraise --protocol 3pc` parses and
    # reaches `appraise` with it (stubbed here: the service's own runs
    # are in test_torch_appraisal.py)
    seen = {}

    def appraise(**kw):
        seen.update(kw)
        return {"throughput": {"n_sessions": 3,
                               "serve_appraisals_per_hour": 2.0,
                               "sequential_appraisals_per_hour": 1.0,
                               "speedup": 2.0},
                "cache": {"hits": 1, "misses": 5},
                "dealer": {"dealer_stall_s": 0.0}, "ledger_agrees": True}
    monkeypatch.setattr(serve, "appraise", appraise)
    serve.main(["--appraise", "--protocol", "3pc", "--device", "cpu"])
    assert seen["protocol"] == "3pc" and seen["device"] == "cpu"
    assert "ledger_agrees=True" in capsys.readouterr().out
