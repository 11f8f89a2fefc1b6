"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab_size=32064,
    rope_theta=1e4, norm_type="layernorm", act="swiglu",
    n_experts=16, moe_top_k=2, d_expert=6400,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
    rope_theta=1e4, norm_type="layernorm", act="swiglu",
    n_experts=4, moe_top_k=2, d_expert=128,
    capacity_factor=4.0,      # dropless at smoke scale: exact decode tests
)
