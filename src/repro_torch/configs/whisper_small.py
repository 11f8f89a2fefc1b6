"""whisper-small [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356].

Backbone-only per the assignment: 12 encoder + 12 decoder layers,
d_model 768, 12 heads (MHA: kv=12), d_ff 3072, vocab 51865. Positional
scheme normalized to RoPE for zoo uniformity (DESIGN.md §8).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_head=64, d_ff=3072, vocab_size=51865,
    rope_theta=1e4, norm_type="layernorm", act="gelu",
    frontend_stub=True,
)

SMOKE = ArchConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab_size=256,
    rope_theta=1e4, norm_type="layernorm", act="gelu",
    frontend_stub=True,
)
