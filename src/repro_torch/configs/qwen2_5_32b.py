"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-32B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, norm_type="rmsnorm", act="swiglu",
)

SMOKE = ArchConfig(
    name="qwen2.5-32b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=192, vocab_size=256,
    qkv_bias=True, rope_theta=1e6, norm_type="rmsnorm", act="swiglu",
)
