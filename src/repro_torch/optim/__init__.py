"""Optimizer and gradient compression over the port's parameter trees —
the port of repro/optim/."""
from repro_torch.optim.adamw import (
    AdamWConfig, init_opt_state, adamw_update, cosine_schedule,
)
from repro_torch.optim.compress import topk_compress_update, int8_allreduce_sim
