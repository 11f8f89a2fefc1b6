"""The paper's own target model (Section 5.1), BERT-base, and the tiny
geometry of the CPU-scale experiments — copied from
repro/configs/paper_targets.py."""
from repro_torch.configs.base import ArchConfig

BERT = ArchConfig(
    name="bert-base", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab_size=30522,
    norm_type="layernorm", act="gelu", rope_theta=1e4,
)

# tiny geometry used by the CPU-scale efficacy experiments
TINY_TARGET = ArchConfig(
    name="tiny-target", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
    d_ff=256, vocab_size=512,
    norm_type="layernorm", act="gelu", rope_theta=1e4,
)
