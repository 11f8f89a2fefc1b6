"""The port against the JAX package on the CPU for the other dense configs
(starcoder2_3b: LayerNorm and a GeLU MLP; glm4_9b: RoPE on half the head
dims): init_params, forward_logits, prefill with two decode steps, and
init_cache, at the smoke configs. The checks and their tolerances are in
zoo_parity.py; the other test_torch_zoo_*.py files take the other
architectures.
"""
import pytest

from zoo_parity import (  # noqa: F401  (collected here)
    test_forward_logits_and_aux_match_jax, test_init_cache_matches_jax,
    test_init_params_keys_shapes_and_scales_match_jax,
    test_prefill_and_decode_match_jax)


@pytest.fixture(scope="module", params=["starcoder2_3b", "glm4_9b"])
def arch(request):
    return request.param
