"""int8 KV caches and the prefill's cache length in the port against the
JAX package, on the CPU, at the smoke configs: `_quant_kv`, an int8
prefill and decode of the dense (qwen2_0_5b) and vlm (paligemma_3b)
families (codes, scales, logits), the JAX package's own quality gate for
the int8 cache, and a prefill whose filled length exceeds max_len.

Weights and inputs as zoo_parity.py says (JAX-built from key 0, carried
with `core.tree.to_device`; numpy tokens and patches). Logits are held
within 1e-4 of max |JAX| (float32 activations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_T
from repro_torch.models import transformer as T
from zoo_parity import (S, assert_close, batch_for, cfgs, jax_batch,
                        jax_weights, run_both)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "paligemma_3b"])
def test_int8_kv_cache_matches_jax(arch):
    """int8 KV caches at float32 activations: prefill and two decode
    steps; the codes within 1 of JAX's (a division that lands on a
    rounding boundary), the scales within 1e-6 relative, the logits
    within the float32 tolerance. The JAX side runs op by op: its
    compiled decode drops the bfloat16 rounding of the dequantized cache
    and of the softmax weights that its code writes (XLA folds the
    convert pairs away), and differs from its own op-by-op decode by
    0.0015 at qwen2_0_5b's smoke config, where the port's differs from
    the op-by-op one by 2e-7."""
    _, (out, cache), (j_out, j_cache) = run_both(
        arch, "float32", op_by_op=True, kv_cache_dtype="int8")
    assert cache["k"].dtype == torch.int8 and "ks" in cache
    for lg, j_lg in zip(out, j_out):
        assert_close(lg, j_lg, "float32")
    for k in ("k", "v"):
        diff = cache[k].int() - torch.from_numpy(np.array(j_cache[k])).int()
        assert int(diff.abs().max()) <= 1, k
    for k in ("ks", "vs"):
        want = np.asarray(j_cache[k])
        assert float(np.abs(cache[k].numpy() - want).max()) <= \
            1e-6 * float(np.abs(want).max()), k


def test_quant_kv_matches_jax():
    """_quant_kv alone: per-(token, head) codes and scales, a zero row
    (scale clamped to 1e-8) included."""
    x = np.random.default_rng(0).standard_normal((2, 7, 3, 16)) \
        .astype(np.float32) * 3
    x[0, 0, 0] = 0
    q, s = T._quant_kv(torch.from_numpy(x))
    jq, js = j_T._quant_kv(jnp.asarray(x))
    assert int((q.int() - torch.from_numpy(np.array(jq)).int())
               .abs().max()) <= 1
    assert float(np.abs(s.numpy() - np.asarray(js)).max()) <= \
        1e-6 * float(np.abs(np.asarray(js)).max())
    assert float(s[0, 0, 0]) == pytest.approx(1e-8)


def test_int8_kv_cache_decode_quality():
    """The JAX package's own gate for its int8 KV cache
    (tests/test_models.py:137-152), on the port: decode logits after an
    int8 prefill track the bf16 teacher-forced ones (correlation > 0.99,
    max |diff| < 0.2), and the cache is int8."""
    _, cfg8 = cfgs("qwen2_0_5b", "bfloat16", kv_cache_dtype="int8")
    _, p = jax_weights("qwen2_0_5b")
    tok = np.random.default_rng(6).integers(0, cfg8.vocab_size, (2, 18))
    tf, _ = T.forward_logits(p, cfg8, {"tokens": tok})
    _, cache = T.prefill(p, cfg8, {"tokens": tok[:, :16]}, max_len=24)
    assert cache["k"].dtype == torch.int8 and "ks" in cache
    lg, cache = T.decode_step(p, cfg8, cache, {"tokens": tok[:, 16:17]}, 16)
    got, want = lg.float().numpy().ravel(), tf[:, 16].float().numpy().ravel()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert float(np.abs(got - want).max()) < 0.2


def test_prefill_longer_than_max_len_raises():
    """The JAX package's _pad_cache cuts a cache to max_len when the
    filled length is longer: its vlm prefill at the default max_len (the
    token count) keeps S of the P + S filled slots. The port raises
    instead, and its default max_len is the filled length."""
    j_cfg, cfg = cfgs("paligemma_3b", "float32")
    jp, p = jax_weights("paligemma_3b")
    batch = batch_for(cfg, 3)
    first = {**batch, "tokens": batch["tokens"][:, :S]}
    filled = cfg.n_prefix_tokens + S
    _, cache = T.prefill(p, cfg, first)
    assert cache["k"].shape[2] == filled
    _, j_cache = j_T.prefill(jp, j_cfg, jax_batch(first))
    assert j_cache["k"].shape[2] == S < filled
    with pytest.raises(ValueError, match="exceeds max_len"):
        T.prefill(p, cfg, first, max_len=filled - 1)
    _, qcfg = cfgs("qwen2_0_5b", "float32")
    with pytest.raises(ValueError, match="exceeds max_len"):
        T.prefill(jax_weights("qwen2_0_5b")[1], qcfg,
                  {"tokens": batch["tokens"]}, max_len=S)
