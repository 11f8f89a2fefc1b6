"""starcoder2-3b [dense] — GQA, RoPE, LayerNorm + plain-GeLU MLP
[arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab_size=49152,
    qkv_bias=True, rope_theta=1e5, norm_type="layernorm", act="gelu",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=256,
    qkv_bias=True, rope_theta=1e5, norm_type="layernorm", act="gelu",
)
