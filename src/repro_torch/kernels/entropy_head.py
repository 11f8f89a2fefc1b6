"""`entropy_head`: per-row softmax entropy of logits (R, V) in one pass,
H = m + log z - s / z — the port of the Pallas kernel
repro/kernels/entropy_head.py:entropy_head, as the CUDA kernel in
csrc/entropy_head.cu: one thread a row for narrow rows, else a row split
across the threads of a block, or across a thread-block cluster when the
rows are few (`plan`), read in 16-byte evict-first loads, the (m, z, s)
triples merged in a fixed order. Float32, bfloat16 or float16 in,
float32 (R,) out. `work` counts what a call must do, for its bound on
the card: bytes.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version `kernels.ref.entropy_head`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels import ref

# launches of the kernel ("kernel") and calls of the plain version on CPU
# tensors ("ref") — the witness that a run went through the kernel
_stats = {"kernel": 0, "ref": 0}

THREADS = 512            # threads a block (csrc/entropy_head.cu)
VECS = 4                 # 16-byte loads a thread issues at once (csrc)
CLUSTER_MAX = 8          # blocks a row, the portable most (csrc)
NARROW_V = 16            # rows this narrow take one thread each
PER_THREAD = 64          # elements a thread walks before a row takes more
MIN_SPLIT = 8            # elements a thread keeps when a row is split
SMS = 132                # streaming multiprocessors of an H100 SXM

_FN = {torch.float32: "entropy_head_f32", torch.bfloat16: "entropy_head_bf16",
       torch.float16: "entropy_head_f16"}
_fns: dict = {}


def plan(r: int, v: int) -> tuple[int, int]:
    """(threads, blocks) a row. Rows of V <= NARROW_V take one thread
    each. Otherwise a row takes a power of two of threads from 32 to
    THREADS: enough that none walks more than PER_THREAD elements, and
    more while the blocks (THREADS / threads rows each) are fewer than
    two a SM. A row that fills a block is split over a cluster of blocks,
    doubling while the blocks are fewer than the SMs and each thread
    keeps MIN_SPLIT elements, up to CLUSTER_MAX."""
    if v <= NARROW_V:
        return 1, 1
    threads = 32
    while threads < THREADS and (
            v > threads * PER_THREAD
            or -(-r // (THREADS // threads)) < 2 * SMS):
        threads *= 2
    blocks = 1
    if threads == THREADS:
        while (blocks < CLUSTER_MAX and r * blocks < SMS
               and v >= 2 * blocks * THREADS * MIN_SPLIT):
            blocks *= 2
    return threads, blocks


def work(r: int, v: int, dtype: torch.dtype) -> tuple[float, float]:
    """(operations, bytes) of one call, for its bound on the card: about
    four operations an element (a max, a subtraction, an exp, a
    multiply-add); the logits read once and H written once, float32."""
    return 4.0 * r * v, float(r * v * torch.finfo(dtype).bits // 8 + 4 * r)


def _fn(dtype: torch.dtype):
    if dtype not in _fns:
        f = getattr(build.lib("entropy_head"), _FN[dtype])
        f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[dtype] = f
    return _fns[dtype]


def launch(logits: torch.Tensor) -> torch.Tensor:
    """Run the kernel on a CUDA tensor of logits (R, V)."""
    refuse_grad("entropy_head", logits)
    if not logits.is_cuda:
        raise ValueError("entropy_head kernel: logits must be on a CUDA "
                         "device")
    if logits.dtype not in _FN:
        raise TypeError(f"entropy_head kernel takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"entropy_head kernel: logits of shape "
                         f"{tuple(logits.shape)}, want (R, V) with V > 0")
    x = logits.contiguous()
    r, v = x.shape
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    err = _fn(x.dtype)(x.data_ptr(), out.data_ptr(), r, v, *plan(r, v),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"entropy_head kernel launch failed: CUDA error "
                           f"{err}")
    _stats["kernel"] += 1
    return out


def entropy_head(logits: torch.Tensor) -> torch.Tensor:
    """Softmax entropy of each row: (R, V) -> (R,) float32."""
    if logits.device.type == "cpu":
        _stats["ref"] += 1
        return ref.entropy_head(logits)
    return launch(logits)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0
