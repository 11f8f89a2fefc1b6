"""Build and load the CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Nothing here runs at import: the first launch on a CUDA tensor builds
the library it needs (`lib(name)`), and `build()` compiles several
sources at once — one nvcc per source, all started together — which is
what `chip_smoke.py` calls up front. Libraries land in `build/` beside
this file (listed in .gitignore), named by a digest of their sources and
flags, so an edited source never loads a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE / "build"
SOURCES = {"ring_matmul": "ring_matmul.cu",
           "secure_matmul": "secure_matmul.cu",
           "flash_attn": "flash_attn.cu",
           "entropy_head": "entropy_head.cu",
           "mlp_softmax_attn": "mlp_softmax_attn.cu",
           "ssd": "ssd.cu",
           "rg_lru": "rg_lru.cu"}
HEADERS = ("ring_tile.cuh", "float_tile.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    in parallel. Returns name -> the compiler's output (`-Xptxas -v`:
    registers, shared memory and spills per kernel); raises with that
    output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (out, tmp, subprocess.Popen(
                [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = {}
        for name, (out, tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
            os.replace(tmp, out)
        return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    if name not in _libs:
        path = target(name)
        if not path.exists():
            build([name])
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
