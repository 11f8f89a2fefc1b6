"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_expert=512
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

Note: the assignment line lists both "MoE 40e top-8" and "32 experts
top-8"; we follow the explicit field "MoE 40e top-8" (matches the HF
granite-3.0-3b-a800m card).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155,
    rope_theta=1e4, norm_type="rmsnorm", act="swiglu",
    n_experts=40, moe_top_k=8, d_expert=512,
)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=256,
    rope_theta=1e4, norm_type="rmsnorm", act="swiglu",
    n_experts=4, moe_top_k=2, d_expert=64,
    capacity_factor=4.0,      # dropless at smoke scale: exact decode tests
)
