"""Dispatch front of the ring kernels, the port of repro/kernels/ops.py.

The device decides, not an `impl` switch: a CUDA tensor launches the
hand-written kernel (or raises — there is no fallback), a CPU tensor
takes the plain torch version, a meta tensor the shape-only fake.

The launch counters (`smm_stats` for secure_matmul, `rmm_stats` for
ring_matmul) count kernel launches under "kernel" and plain-version
calls under "ref". The executor snapshots them around a phase
(`DeviceReport.combine_*` / `matmul_*`), which is how a run on the card
shows that its products went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import ring_matmul as _rmm
from repro_torch.kernels import secure_matmul as _smm

ring_matmul = _rmm.ring_matmul


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
