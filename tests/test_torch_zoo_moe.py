"""The port against the JAX package on the CPU for the moe configs
(granite_moe_3b, 40 experts top-8 at full size; phi3_5_moe, 16 experts
top-2 with LayerNorm), the MoE FFN in every layer: init_params,
forward_logits, prefill with two decode steps, and init_cache, at the
smoke configs. The checks and their tolerances are in zoo_parity.py; the
other test_torch_zoo_*.py files take the other architectures.
"""
import pytest

from zoo_parity import (  # noqa: F401  (collected here)
    test_forward_logits_and_aux_match_jax, test_init_cache_matches_jax,
    test_init_params_keys_shapes_and_scales_match_jax,
    test_prefill_and_decode_match_jax)


@pytest.fixture(scope="module", params=["granite_moe_3b", "phi3_5_moe"])
def arch(request):
    return request.param
