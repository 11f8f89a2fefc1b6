"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's: the six cases of tests/test_checkpoint.py run on the port
(newest COMMIT wins, a partial step, a bad crc and a bad manifest are
skipped, exotic dtypes round trip as uint views, `_gc` keeps the newest
k), then steps written by either package restored by the other with
equal leaves (int32, int64, float32 and bfloat16, in nested dicts and
lists, so the leaf order is JAX's pytree order)."""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.core.tree import tree_leaves


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((4, 3))
                                  .astype(np.float32)),
            "b": rng.standard_normal(3).astype(np.float32),
            "step": torch.tensor(seed, dtype=torch.int64)}


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_restore_picks_newest_commit(tmp_path):
    d = str(tmp_path)
    for step in (1, 5, 3):
        ckpt.save_checkpoint(d, step, _tree(step))
    assert ckpt.latest_step(d) == 5
    got, step = ckpt.restore_checkpoint(d, _tree(0))
    assert step == 5
    _assert_trees_equal(got, _tree(5))


def test_restore_skips_partial_step_missing_commit(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree(1))
    ckpt.save_checkpoint(d, 2, _tree(2))
    # a crash mid-save of step 3: shard + manifest landed, COMMIT did not
    os.remove(os.path.join(ckpt.save_checkpoint(d, 3, _tree(3)), "COMMIT"))
    assert ckpt.latest_step(d) == 2
    got, step = ckpt.restore_checkpoint(d, _tree(0))
    assert step == 2
    _assert_trees_equal(got, _tree(2))


def test_restore_skips_corrupt_shard_crc(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree(1))
    step_dir = ckpt.save_checkpoint(d, 2, _tree(2))
    mpath = os.path.join(step_dir, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["leaves"][0]["crc32"] ^= 0xDEAD
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    got, step = ckpt.restore_checkpoint(d, _tree(0))
    assert step == 1
    _assert_trees_equal(got, _tree(1))


def test_restore_skips_corrupt_manifest_json(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree(1))
    step_dir = ckpt.save_checkpoint(d, 2, _tree(2))
    with open(os.path.join(step_dir, "manifest.json"), "w") as f:
        f.write("{ not json")
    got, step = ckpt.restore_checkpoint(d, _tree(0))
    assert step == 1


def test_exotic_dtype_uint_view_roundtrip(tmp_path):
    d = str(tmp_path)
    gen = torch.Generator().manual_seed(0)
    tree = {
        "bf16": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
        "fp8": torch.randn(7, generator=gen).to(torch.float8_e4m3fn),
        "f32": torch.randn(4, generator=gen),
    }
    ckpt.save_checkpoint(d, 1, tree)
    # on disk the exotic leaves are uint views, logical dtype recorded
    step_dir = os.path.join(d, "step_00000001")
    manifest = json.load(open(os.path.join(step_dir, "manifest.json")))
    by_logical = {e["logical_dtype"]: e["dtype"] for e in manifest["leaves"]}
    assert by_logical["bfloat16"] == "uint16"
    assert by_logical["float8_e4m3fn"] == "uint8"
    got, step = ckpt.restore_checkpoint(d, tree)
    assert step == 1
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k].view(torch.uint8), tree[k].view(torch.uint8))


def test_gc_keeps_newest_k(tmp_path):
    d = str(tmp_path)
    for step in range(1, 6):
        ckpt.save_checkpoint(d, step, _tree(step), keep=2)
    assert sorted(ckpt._steps(d)) == [4, 5]


def test_async_checkpointer_copies_before_returning(tmp_path):
    """The saved step holds the leaves as they were when `save` returned,
    though the caller mutates them in place right after."""
    d = str(tmp_path)
    tree = _tree(3)
    saver = ckpt.AsyncCheckpointer(d)
    saver.save(7, tree)
    tree["w"].add_(1.0)
    saver.wait()
    got, step = ckpt.restore_checkpoint(d, tree)
    assert step == 7
    _assert_trees_equal(got, _tree(3))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _numpy_tree(seed: int):
    """The JAX package's leaves: numpy arrays, bf16 from ml_dtypes."""
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "h": rng.standard_normal(5).astype(
                            ml_dtypes.bfloat16)},
                       {"w": rng.standard_normal((2, 2)).astype(np.float32),
                        "h": rng.standard_normal(1).astype(
                            ml_dtypes.bfloat16)}],
            "count": rng.integers(-2 ** 31, 2 ** 31, 6).astype(np.int32),
            "ring": rng.integers(-2 ** 63, 2 ** 63 - 1, (2, 3),
                                 dtype=np.int64),
            "b_scale": rng.standard_normal(()).astype(np.float32)}


def _as_torch(tree):
    """The same leaves as the port's tensors (bf16 by its bit pattern)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _bits(leaf) -> tuple:
    """(logical dtype name, shape, raw bytes) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        flat = leaf.reshape(-1).view(torch.uint8)
        return name, tuple(leaf.shape), flat.numpy().tobytes()
    leaf = np.asarray(leaf)
    return leaf.dtype.name, leaf.shape, leaf.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_port_writes_jax_restores(tmp_path, seed):
    d = str(tmp_path)
    want = _numpy_tree(seed)
    ckpt.save_checkpoint(d, 4, _as_torch(want))
    got, step = j_ckpt.restore_checkpoint(d, _numpy_tree(seed + 10))
    assert step == 4
    import jax
    j_leaves = jax.tree_util.tree_leaves(got)
    assert [_bits(x) for x in j_leaves] == \
        [_bits(x) for x in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_writes_port_restores(tmp_path, seed):
    d = str(tmp_path)
    want = _numpy_tree(seed)
    j_ckpt.save_checkpoint(d, 9, want)
    got, step = ckpt.restore_checkpoint(d, _as_torch(_numpy_tree(seed + 10)))
    assert step == 9
    assert [_bits(x) for x in tree_leaves(got)] == \
        [_bits(x) for x in tree_leaves(_as_torch(want))]
    assert got["layers"][1]["h"].dtype == torch.bfloat16
