"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, norm_type="rmsnorm", act="swiglu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
    qkv_bias=True, rope_theta=1e6, norm_type="rmsnorm", act="swiglu",
    tie_embeddings=True,
)
