"""The port's training driver (`launch/train.py`) on the CPU:

  * `make_train_step`, 3 steps from carried smoke weights (qwen2_0_5b at
    float32), against the JAX package's step: each step's loss within
    1e-5 of |JAX| and grad norm within 1e-4, and after the 3 steps every
    parameter leaf within 1e-4 of its max |JAX|, but the key bias: its
    gradient is 0 up to rounding (softmax ignores a bias shared by every
    key), which Adam scales to steps of +-lr either way, so it is held
    within 2 lr a step;
  * `train` then a second `train` resuming from its checkpoint, and the
    loss falling over 30 steps, as tests/test_launch.py checks the JAX
    launcher; `train` refusing a directory whose checkpoint is of another
    configuration (another leaf count, or a leaf of another shape);
  * `model_parallel != 1` raising (multi-device is not ported), `main`
    at smoke size, `--arch` offering every architecture.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import train as j_train
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.launch import train as tr
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from zoo_parity import jax_weights, leaves

ARCH = "qwen2_0_5b"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The smoke models' small CPU products on two threads: under the
    suite's parallel workers torch's full thread pool spins and the
    module takes minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_make_train_step_matches_jax_over_three_steps():
    j_cfg = dataclasses.replace(j_base.load_arch(ARCH, smoke=True),
                                dtype="float32")
    cfg = dataclasses.replace(base.load_arch(ARCH, smoke=True),
                              dtype="float32")
    opt, j_opt = adamw.AdamWConfig(total_steps=3, warmup_steps=1), \
        j_adamw.AdamWConfig(total_steps=3, warmup_steps=1)
    jp, _ = jax_weights(ARCH)
    # the port's step writes its params in place: a copy of its own
    p = tree.to_device(jax.tree.map(np.asarray, jp), "cpu")
    j_step = jax.jit(j_train.make_train_step(j_cfg, j_opt, True))
    step = tr.make_train_step(cfg, opt, True)
    state, j_state = adamw.init_opt_state(p), j_adamw.init_opt_state(jp)
    for i in range(3):
        b = synth_lm_batch(0, i, 0, 1, 2, 16, cfg.vocab_size)
        jp, j_state, j_loss, j_gn = j_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in b.items()})
        p, state, loss, gn = step(p, state, b)
        assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        assert abs(float(gn) - float(j_gn)) <= 1e-4 * abs(float(j_gn))
    lr = float(adamw.cosine_schedule(opt, 3))
    for path, x in leaves(p).items():
        want = np.asarray(leaves(jax.tree.map(np.asarray, jp))[path])
        err = np.abs(x.numpy() - want)
        bound = 1e-4 * float(np.abs(want).max())
        if path[-1] == "bk":
            # softmax ignores a bias shared by every key: its gradient is
            # 0 up to rounding, which Adam scales to steps of +-lr
            assert (err <= 2 * lr * 3).all(), path
        else:
            assert (err <= bound).all(), path
        assert not x.requires_grad


def test_train_resumes_from_its_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")
    out = tr.train(tr.TrainConfig(arch=ARCH, steps=8, batch=4, seq=32,
                                  ckpt_dir=ckpt, ckpt_every=4, log_every=100,
                                  device="cpu"))
    assert out["resumed_from"] == 0 and len(out["losses"]) == 8
    assert np.isfinite(out["final_loss"]) and out["healthy"]
    out2 = tr.train(tr.TrainConfig(arch=ARCH, steps=12, batch=4, seq=32,
                                   ckpt_dir=ckpt, ckpt_every=4,
                                   log_every=100, device="cpu"))
    assert out2["resumed_from"] == 8 and len(out2["losses"]) == 4


@pytest.mark.parametrize("other", ["leaf_count", "leaf_shape"])
def test_train_refuses_a_checkpoint_of_another_config(tmp_path, other):
    """A directory holding another configuration's step: `train` raises
    and writes nothing, where it would resume from (or start over beside)
    tensors of the wrong size."""
    cfg = base.load_arch(ARCH, smoke=True)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    if other == "leaf_count":
        state = {"params": params}
    else:
        ls = tree.tree_leaves(state)
        ls[0] = torch.zeros((ls[0].shape[0] + 1,) + ls[0].shape[1:],
                            dtype=ls[0].dtype)
        state = tree.tree_rebuild(state, ls)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, 4, state)
    with pytest.raises(ValueError, match="step 4"):
        tr.train(tr.TrainConfig(arch=ARCH, steps=8, batch=2, seq=16,
                                ckpt_dir=ckpt, device="cpu"))
    assert sorted(os.listdir(ckpt)) == ["step_00000004"]


def test_loss_decreases_over_training(tmp_path):
    out = tr.train(tr.TrainConfig(arch=ARCH, steps=30, batch=8, seq=64,
                                  ckpt_dir=str(tmp_path / "ck2"),
                                  ckpt_every=1000, log_every=1000,
                                  device="cpu"))
    assert out["final_loss"] < out["first_loss"]


def test_model_parallel_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        tr.train(tr.TrainConfig(arch=ARCH, steps=1, model_parallel=2,
                                ckpt_dir=str(tmp_path), device="cpu"))


def test_main_at_smoke_size_and_every_arch(tmp_path, capsys):
    tr.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
             "16", "--ckpt-dir", str(tmp_path / "m")])
    assert "[train] done:" in capsys.readouterr().out
    assert tr.TrainConfig().device == "cuda"
    # one directory per configuration, under TMPDIR
    root = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    assert tr.default_ckpt_dir(ARCH, True) == os.path.join(
        root, f"{ARCH}_smoke")
    assert tr.default_ckpt_dir(ARCH, False) == os.path.join(
        root, f"{ARCH}_full")
    with pytest.raises(SystemExit):
        tr.main(["--arch", "nope"])
    assert base.ARCH_IDS == j_base.ARCH_IDS
