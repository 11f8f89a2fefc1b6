"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    norm_type="rmsnorm", act="silu",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, conv_width=4,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=256,
    norm_type="rmsnorm", act="silu",
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, conv_width=4,
    tie_embeddings=True,
)
