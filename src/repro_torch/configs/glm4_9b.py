"""glm4-9b [dense] — partial RoPE (half dims), GQA [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab_size=151552,
    qkv_bias=True, rope_theta=1e4, rope_fraction=0.5,
    norm_type="rmsnorm", act="swiglu",
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=192, vocab_size=256,
    qkv_bias=True, rope_theta=1e4, rope_fraction=0.5,
    norm_type="rmsnorm", act="swiglu",
)
