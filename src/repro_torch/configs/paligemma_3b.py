"""paligemma-3b [vlm] — SigLIP frontend STUB (precomputed patch
embeddings) + gemma-2b decoder with prefix-LM masking [arXiv:2407.07726].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=257216,
    rope_theta=1e4, norm_type="rmsnorm", act="geglu",
    n_prefix_tokens=256, frontend_stub=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab_size=256,
    rope_theta=1e4, norm_type="rmsnorm", act="geglu",
    n_prefix_tokens=8, frontend_stub=True, tie_embeddings=True,
)
