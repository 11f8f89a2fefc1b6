"""Build and load the CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Nothing here runs at import: the first launch on a CUDA tensor builds
the library it needs (`lib(name)`), and `build()` compiles several
sources at once — one nvcc per source, all started together — which is
what `chip_smoke.py` calls up front. Libraries land in `build/` beside
this file (listed in .gitignore), named by a digest of their sources and
flags, so an edited source never loads a stale library, each with the
compiler's report beside it (`ptxas_log`). `sass` disassembles a built
library, so a run can show which instructions a kernel issues.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
           "rg_lru": "rg_lru.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "mlp_softmax_attn_bwd": "mlp_softmax_attn_bwd.cu",
           "ssd_bwd": "ssd_bwd.cu",
           "rg_lru_bwd": "rg_lru_bwd.cu"}
HEADERS = ("float_tile.cuh", "hopper_tile.cuh", "wgmma_ops.cuh",
           "ring_limbs.cuh")
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


def build(names=None) -> None:
    """Compile the named kernels (all by default) that are not built yet,
    in parallel, keeping each one's compiler output (`-Xptxas -v`:
    registers, shared memory and spills per kernel) beside its library;
    raises with that output if a build fails."""
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
        for name, (out, tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)


def ptxas_log(name: str) -> str:
    """The compiler's output from the build of kernel `name` (kept beside
    its library)."""
    return target(name).with_suffix(".log").read_text()


def ptxas_entries(log: str) -> dict[str, dict]:
    """Registers and spill bytes per kernel entry in a `-Xptxas -v`
    report: mangled name -> {"registers", "spill_stores",
    "spill_loads"}."""
    out: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return out


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(found):
        return found
    try:
        import triton
        found = str(Path(triton.__file__).parent / "backends" / "nvidia"
                    / "bin" / "cuobjdump")
    except ImportError:
        pass
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found (CUDA toolkit or triton)")
    return found


def sass(name: str) -> str:
    """The SASS of kernel `name`'s built library (`cuobjdump -sass`)."""
    lib(name)
    return subprocess.run([cuobjdump(), "-sass", str(target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_counts(text: str, opcode: str) -> dict[str, int]:
    """Instructions of `opcode` (e.g. HGMMA, the tensor cores' bf16/tf32
    warpgroup product) per function in a `cuobjdump -sass` listing."""
    out: dict[str, int] = {}
    fn = None
    pat = re.compile(rf"\b{opcode}\b")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn is not None and pat.search(line):
            out[fn] += 1
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    if name not in _libs:
        path = target(name)
        if not path.exists():
            build([name])
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
