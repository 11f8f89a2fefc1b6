"""Dispatch front of the kernels, the port of repro/kernels/ops.py.

The device decides, not an `impl` switch: a CUDA tensor launches the
hand-written kernel (or raises — there is no fallback), a CPU tensor
takes the plain torch version, a meta tensor (ring kernels only) the
shape-only fake.

The launch counters (`smm_stats` for secure_matmul, `rmm_stats` for
ring_matmul, `fa_stats` for flash_attn, `eh_stats` for entropy_head,
`msa_stats` for mlp_softmax_attn, `ssd_stats` for ssd, `lru_stats` for
rg_lru) count kernel launches under "kernel"
and plain-version calls under "ref"; `fa_bwd_stats`, `msa_bwd_stats`,
`ssd_bwd_stats` and `lru_bwd_stats` count the backward kernels the same
way. The executor snapshots the ring
counters around a phase (`DeviceReport.combine_*` / `matmul_*`); a run
on the card reads them all to show that its work went through the
kernels.
"""
from __future__ import annotations

from repro_torch.kernels import entropy_head as _eh
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import mlp_softmax_attn as _msa
from repro_torch.kernels import rg_lru as _lru
from repro_torch.kernels import ring_matmul as _rmm
from repro_torch.kernels import secure_matmul as _smm
from repro_torch.kernels import ssd as _ssd

ring_matmul = _rmm.ring_matmul
flash_attn = _fa.flash_attn
entropy_head = _eh.entropy_head
mlp_softmax_attn = _msa.mlp_softmax_attn
ssd_chunked = _ssd.ssd_chunked
rg_lru_scan = _lru.rg_lru_scan


def secure_matmul(eps, dlt, a_sh, b_sh, c_sh):
    """Beaver post-open combine, both parties fused: eps (..., M, K),
    dlt (..., K, N), a/b/c shares (2, ..., *) -> z (2, ..., M, N)."""
    return _smm.secure_matmul_op(eps, dlt, a_sh, b_sh, c_sh)


def smm_stats() -> dict:
    """Snapshot of the secure_matmul counters (kernel / ref / padded)."""
    return _smm.stats()


def reset_smm_stats() -> None:
    _smm.reset_stats()


def rmm_stats() -> dict:
    """Snapshot of the ring_matmul counters (kernel / ref)."""
    return _rmm.stats()


def reset_rmm_stats() -> None:
    _rmm.reset_stats()


def fa_stats() -> dict:
    """Snapshot of the flash_attn counters (kernel / ref)."""
    return _fa.stats()


def reset_fa_stats() -> None:
    _fa.reset_stats()


def eh_stats() -> dict:
    """Snapshot of the entropy_head counters (kernel / ref)."""
    return _eh.stats()


def reset_eh_stats() -> None:
    _eh.reset_stats()


def msa_stats() -> dict:
    """Snapshot of the mlp_softmax_attn counters (kernel / ref)."""
    return _msa.stats()


def reset_msa_stats() -> None:
    _msa.reset_stats()


def ssd_stats() -> dict:
    """Snapshot of the ssd counters (kernel / ref)."""
    return _ssd.stats()


def reset_ssd_stats() -> None:
    _ssd.reset_stats()


def lru_stats() -> dict:
    """Snapshot of the rg_lru counters (kernel / ref)."""
    return _lru.stats()


def reset_lru_stats() -> None:
    _lru.reset_stats()


def fa_bwd_stats() -> dict:
    """Snapshot of the flash_attn backward counters (kernel / ref)."""
    return _fa.bwd_stats()


def reset_fa_bwd_stats() -> None:
    _fa.reset_bwd_stats()


def msa_bwd_stats() -> dict:
    """Snapshot of the mlp_softmax_attn backward counters (kernel / ref)."""
    return _msa.bwd_stats()


def reset_msa_bwd_stats() -> None:
    _msa.reset_bwd_stats()


def ssd_bwd_stats() -> dict:
    """Snapshot of the ssd backward counters (kernel / ref)."""
    return _ssd.bwd_stats()


def reset_ssd_bwd_stats() -> None:
    _ssd.reset_bwd_stats()


def lru_bwd_stats() -> dict:
    """Snapshot of the rg_lru backward counters (kernel / ref)."""
    return _lru.bwd_stats()


def reset_lru_bwd_stats() -> None:
    _lru.reset_bwd_stats()
