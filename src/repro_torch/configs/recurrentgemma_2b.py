"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern
(rec, rec, attn), window 2048 [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab_size=256000,
    rope_theta=1e4, norm_type="rmsnorm", act="geglu",
    block_pattern=("rec", "rec", "attn"), window_size=2048, lru_width=2560,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab_size=256,
    rope_theta=1e4, norm_type="rmsnorm", act="geglu",
    block_pattern=("rec", "rec", "attn"), window_size=16, lru_width=64,
    tie_embeddings=True,
)
