"""Architecture config schema — the port of repro/configs/base.py's
`ArchConfig` (framework-free, copied as it is) and its registry
(`ARCH_IDS`, `load_arch`). Every architecture of the model zoo is an
ArchConfig in its own module (repro_torch/configs/<id>.py, a copy of the
JAX package's) exposing CONFIG (full) and SMOKE (reduced, same family);
the paper's own targets are in configs/paper_targets.py. The shape
registry (`ShapeSpec`, `SHAPES`, `cell_is_applicable`) belongs to the
dry-run launcher and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0          # glm4 applies RoPE to half the dims
    norm_type: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1        # routing groups; launcher sets = #data shards
    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    window_size: int = 0                 # local attention window
    lru_width: int = 0
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    # enc-dec
    n_enc_layers: int = 0
    n_cross_kv: int = 1500               # whisper encoder frames at decode
    # vlm
    n_prefix_tokens: int = 0             # image patch embeddings prepended
    # modality frontends are stubs: input_specs() provides embeddings
    frontend_stub: bool = False
    dtype: str = "bfloat16"
    # scan unrolling (1 = rolled while-loop; dryrun's cost pass sets it to
    # n_layers so HLO cost analysis counts every layer)
    scan_unroll: int = 1
    # cast f32 master params to bf16 BEFORE the layer scan so FSDP
    # all-gathers move bf16, not f32 (2x weight-gather traffic; §Perf)
    bf16_param_gather: bool = False
    # KV cache storage: "bf16" | "int8" (per-token-per-head symmetric
    # quant; halves decode HBM streaming — dense family, §Perf)
    kv_cache_dtype: str = "bf16"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """May run long_500k (bounded state / local window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            per = (d * (2 * d_in + 2 * self.ssm_state + nh)
                   + self.conv_width * (d_in + 2 * self.ssm_state)
                   + d_in * d + 2 * d_in + 3 * nh + d)
            return emb + self.n_layers * per
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        glu = self.act in ("swiglu", "geglu")
        if self.family == "moe":
            ffn = (d * self.n_experts
                   + self.n_experts * (d * self.d_expert * (3 if glu else 2)))
            if self.n_shared_experts:
                ffn += d * self.n_shared_experts * self.d_expert * (3 if glu else 2)
        else:
            ffn = d * self.d_ff * (3 if glu else 2)
        per = attn + ffn + 2 * d
        n_attn_layers = self.n_layers
        total = emb
        if self.family == "hybrid":
            pat = self.block_pattern or ("attn",)
            n_rec = sum(1 for b in self._layer_kinds() if b == "rec")
            n_att = self.n_layers - n_rec
            lru = self.lru_width
            rec_per = (2 * d * lru + self.conv_width * lru
                       + 2 * lru * lru + lru * d + 4 * lru) + ffn + 2 * d
            return emb + n_att * per + n_rec * rec_per
        if self.family == "encdec":
            cross = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
                + self.n_heads * self.d_head * d
            return (emb + self.n_enc_layers * per
                    + self.n_layers * (per + cross + d))
        return total + n_attn_layers * per

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        glu = self.act in ("swiglu", "geglu")
        full_ffn = self.n_experts * d * self.d_expert * (3 if glu else 2)
        act_ffn = self.moe_top_k * d * self.d_expert * (3 if glu else 2)
        return self.param_count() - self.n_layers * (full_ffn - act_ffn)

    def _layer_kinds(self) -> list[str]:
        if self.family == "hybrid" and self.block_pattern:
            pat = list(self.block_pattern)
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.family == "ssm":
            return ["ssd"] * self.n_layers
        return ["attn"] * self.n_layers


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# the JAX package's zoo, in its order
ARCH_IDS = [
    "qwen2_0_5b", "qwen2_5_32b", "starcoder2_3b", "glm4_9b",
    "recurrentgemma_2b", "granite_moe_3b", "phi3_5_moe", "whisper_small",
    "mamba2_2_7b", "paligemma_3b",
]


def load_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is unknown; the zoo: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE if smoke else mod.CONFIG
