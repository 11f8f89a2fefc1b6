"""Checkpoints: manifest-verified .npz shards, atomic rename, async save
thread, auto-resume — the port of repro/checkpoint/ckpt.py.

Layout:  <dir>/step_<N>/shard_<host>.npz     flattened tree leaves
         <dir>/step_<N>/manifest.json        structure + shapes + crc32s
         <dir>/step_<N>/COMMIT               written last (atomicity mark)

Restore picks the newest COMMITted step, verifies the manifest, and
rebuilds the tree. Corrupt/partial steps (no COMMIT or crc mismatch)
are skipped — the restart path after a mid-save node failure.

The layout is the JAX package's, so a step written by either package
restores in the other with equal leaves. Leaves are flattened in JAX's
pytree order (`core.tree.tree_leaves`: dict keys sorted). A tree may
hold tensors (on any device) or numpy arrays; restored leaves are CPU
tensors. Dtypes numpy lacks (bfloat16, float8) are stored as unsigned
integer views with their logical dtype in the manifest, as the JAX
package stores them, and come back through `Tensor.view` (no
`ml_dtypes`). The manifest's structure string is this package's own;
neither package reads it on restore. The crc32s are computed on worker
threads (zlib releases the GIL): beside the shard's write on save, and
with each thread's share of the leaves read on restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_rebuild

_NUMPY_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint64", "uint32", "uint16", "uint8", "bool")
_UINT_VIEW = {2: torch.int16, 1: torch.int8}  # bf16/fp8: not numpy-native
_IO_THREADS = min(8, os.cpu_count() or 1)


def _structure(tree) -> str:
    return repr(tree_rebuild(tree, ["*"] * len(tree_leaves(tree))))


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """(storable numpy array, logical dtype name). Exotic dtypes -> uint
    view, as the JAX package stores them."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, a.dtype.name
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _NUMPY_NATIVE:
        return t.numpy(), name
    size = t.element_size()
    return (t.view(_UINT_VIEW[size]).numpy().view(f"uint{8 * size}"),
            name)


def _crc32(a: np.ndarray) -> int:
    # over the array's buffer: the same crc as over its bytes, without a
    # copy of each leaf
    return zlib.crc32(np.ascontiguousarray(a))


def _from_storable(a: np.ndarray, logical: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    if a.dtype.name == logical:
        return t
    return t.view(getattr(torch, logical))


def save_checkpoint(ckpt_dir: str, step: int, tree, *, host: int = 0,
                    keep: int = 3) -> str:
    stored = [_to_storable(leaf) for leaf in tree_leaves(tree)]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(stored)}
    logical = [d for _, d in stored]
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    shard = os.path.join(step_dir, f"shard_{host}.npz")
    tmp = shard + ".tmp.npz"          # keep .npz suffix: np.savez appends it
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        crcs = pool.map(_crc32, arrays.values())
        np.savez(tmp, **arrays)
        crcs = list(crcs)
    os.replace(tmp, shard)
    manifest = {
        "step": step,
        "treedef": _structure(tree),
        "leaves": [{"name": f"leaf_{i}", "shape": list(a.shape),
                    "dtype": str(a.dtype), "logical_dtype": logical[i],
                    "crc32": crcs[i]}
                   for i, a in enumerate(arrays.values())],
    }
    mpath = os.path.join(step_dir, "manifest.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    with open(os.path.join(step_dir, "COMMIT"), "w") as f:
        f.write("ok")
    _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like, *, step: int | None = None,
                       host: int = 0):
    """Restore into the structure of `tree_like`. Returns (tree, step) or
    (tree_like, None) if no valid checkpoint exists."""
    steps = sorted(_steps(ckpt_dir), reverse=True)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in steps:
        step_dir = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            with open(os.path.join(step_dir, "manifest.json")) as f:
                manifest = json.load(f)
            entries = manifest["leaves"]
            if len(tree_leaves(tree_like)) != len(entries):
                raise IOError("leaf count mismatch")
            shard = os.path.join(step_dir, f"shard_{host}.npz")
            k = max(1, min(_IO_THREADS, len(entries)))
            with ThreadPoolExecutor(k) as pool:
                parts = list(pool.map(
                    lambda i: _read_checked(shard, entries[i::k]), range(k)))
            arrays = [parts[i % k][i // k] for i in range(len(entries))]
            restored = [_from_storable(a, e.get("logical_dtype",
                                                str(a.dtype)))
                        for a, e in zip(arrays, manifest["leaves"])]
            return tree_rebuild(tree_like, restored), s
        except Exception:
            continue          # corrupt step: fall through to older one
    return tree_like, None


def _read_checked(shard: str, entries: list) -> list:
    """The arrays of manifest `entries` from one open of `shard`, each
    checked against its crc32."""
    with np.load(shard) as z:
        arrays = [z[e["name"]] for e in entries]
    for a, e in zip(arrays, entries):
        if _crc32(a) != e["crc32"]:
            raise IOError(f"crc mismatch in {e['name']}")
    return arrays


def _host_copy(leaf):
    """A host copy the caller cannot mutate after `save` returns."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Non-blocking saves: device->host copy on the caller, disk IO on a
    background thread (one in flight; newer save waits for the previous)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree) -> None:
        host_tree = tree_rebuild(tree, [_host_copy(x)
                                        for x in tree_leaves(tree)])
        self.wait()
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.ckpt_dir, step, host_tree),
            kwargs={"keep": self.keep}, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
