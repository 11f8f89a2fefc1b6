"""The arithmetic of the rg_lru kernel (csrc/rg_lru.cu), on the CPU,
against the plain versions: the port's `kernels.ref.rg_lru`, the JAX
package's jnp oracle `repro.kernels.ref.rg_lru` and its Pallas kernel in
interpret mode (run as tests/test_torch_ssm.py runs it).

The kernel is a one-pass chunked scan. A block owns 32 channels of one
batch row (a lane each, lanes past D masked) and walks T in tiles of
WARPS x STEPS steps (`rg_lru.plan`; steps past T masked); in a tile each
warp reduces its STEPS steps, in step order, to (P, S) = (the product of
its a, its scan from 0), folds the earlier warps' (P, S) into the tile's
carry-in in warp order, and recomputes h_t = a_t h + b_t from the
result over its steps; the last warp's final h is the next tile's
carry-in. A masked step is a = 1, b = 0. `kernel_model` below is that
arithmetic in plain torch, float32, one rounding a product and one a sum
(no fused multiply-add), as the kernel's `__fmul_rn` / `__fadd_rn`: a
model for this test that runs on no path.

Tolerance: 1e-5 of max(1, max |want|), the kernel's tolerance on the
card (chip_smoke.py's SCAN_TOL, the JAX package's for the same kernel).
Only a chunk's carry-in is rounded otherwise than in the serial loop:
float32 chunked against float32 serial at (4, 512, 256), chunks of 16
to 64, measured 6.5e-8 (a = sigmoid(N(0, 1))) and 2.4e-7 (a in the
model's gate range [0.9, 0.9999]) of max(1, max |h|), 40x or more inside
it. `rg_lru.work` is checked at the serving path's case.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import ref
from repro_torch.kernels import rg_lru as lru

TOL = 1e-5
SOURCE = Path(lru.__file__).parent / "csrc" / "rg_lru.cu"


def inputs(shape, a_kind="sigmoid", b0_scale=1.0, seed=0):
    """a, b (B, T, D) float32 numpy: a = sigmoid(N(0, 1)), 0, 1, or in
    the gate range [0.9, 0.9999] with b = sqrt(1 - a^2) N(0, 1), as the
    model scales it; b_0 times b0_scale (an initial state folded in)."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(shape)
    if a_kind == "gate":
        a = rng.uniform(0.9, 0.9999, shape)
        b = np.sqrt(1 - a * a) * noise
    else:
        a = {"sigmoid": lambda: 1 / (1 + np.exp(-rng.standard_normal(shape))),
             "zero": lambda: np.zeros(shape),
             "one": lambda: np.ones(shape)}[a_kind]()
        b = noise
    b[:, 0] *= b0_scale
    return a.astype(np.float32), b.astype(np.float32)


def kernel_model(a, b):
    """h (B, T, D) float32 as the kernel computes it, and the count of
    stores of each (batch, step, channel)."""
    bsz, t, d = a.shape
    tiles, groups = lru.plan(t, d)
    tile = lru.WARPS * lru.STEPS
    h = torch.full((bsz, t, d), float("nan"))
    stores = torch.zeros((bsz, t, d), dtype=torch.int64)
    one, zero = torch.ones((bsz, lru.LANES)), torch.zeros((bsz, lru.LANES))
    for g in range(groups):
        lanes = torch.arange(g * lru.LANES, (g + 1) * lru.LANES)
        live = lanes < d
        cols = lanes.clamp(max=d - 1)

        def step(s):
            """The block's a and b of step s, masked."""
            if s >= t:
                return one, zero
            return (torch.where(live, a[:, s, cols], one),
                    torch.where(live, b[:, s, cols], zero))
        carry = zero
        for k in range(tiles):
            chunks = []                          # (P, S) of each warp
            for w in range(lru.WARPS):
                p, s = one, zero
                for j in range(lru.STEPS):
                    at, bt = step(k * tile + w * lru.STEPS + j)
                    p = p * at
                    s = at * s + bt
                chunks.append((p, s))
            for w in range(lru.WARPS):
                hv = carry
                for p, s in chunks[:w]:                   # warp order
                    hv = p * hv + s
                for j in range(lru.STEPS):
                    i = k * tile + w * lru.STEPS + j
                    at, bt = step(i)
                    hv = at * hv + bt
                    if i < t:
                        h[:, i, cols[live]] = hv[:, live]
                        stores[:, i, cols[live]] += 1
                if w == lru.WARPS - 1:
                    carry = hv
    return h, stores


def assert_close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# (B, T, D), a, b_0 scale: the serving path's (4, 512, 2560) with D cut
# to two lane groups, in both input ranges; T of 1, 15, 16 (one warp's
# chunk), 129 (past a tile) and 512; D of 1, 31, 33 and 300; a = 0,
# a = 1 and a large initial state folded into b_0
CASES = {"path, D 64": ((4, 512, 64), "sigmoid", 1.0),
         "path, D 64, gate range": ((4, 512, 64), "gate", 1.0),
         "T 1, D 300": ((3, 1, 300), "sigmoid", 1.0),
         "T 15, D 31": ((2, 15, 31), "sigmoid", 1.0),
         "T 16, D 1": ((2, 16, 1), "gate", 1.0),
         "T 129, D 300": ((2, 129, 300), "sigmoid", 1.0),
         "T 512, D 33": ((2, 512, 33), "gate", 1.0),
         "a = 0": ((2, 129, 33), "zero", 1.0),
         "a = 1": ((2, 129, 33), "one", 1.0),
         "large initial state": ((2, 129, 31), "gate", 100.0),
         "large initial state, T 512": ((1, 512, 40), "sigmoid", 100.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_plain(case):
    a, b = inputs(*CASES[case])
    got, stores = kernel_model(torch.from_numpy(a), torch.from_numpy(b))
    assert bool((stores == 1).all())
    assert_close(got, ref.rg_lru(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_jax_oracle(case):
    a, b = inputs(*CASES[case], seed=1)
    want = np.asarray(j_ref.rg_lru(jnp.asarray(a), jnp.asarray(b)))
    assert_close(kernel_model(torch.from_numpy(a), torch.from_numpy(b))[0],
                 want)


# the Pallas kernel's time tile bt must divide T: (B, T, D), a, bt
@pytest.mark.parametrize("shape,a_kind,bt", [((4, 512, 64), "sigmoid", 128),
                                             ((2, 512, 33), "gate", 128),
                                             ((2, 16, 31), "sigmoid", 16),
                                             ((2, 15, 300), "gate", 15),
                                             ((3, 1, 33), "sigmoid", 1)])
def test_kernel_model_matches_pallas_interpret(shape, a_kind, bt):
    a, b = inputs(shape, a_kind, seed=2)
    want = np.asarray(j_ops.rg_lru_scan(jnp.asarray(a), jnp.asarray(b),
                                        impl="interpret", bt=bt))
    assert_close(kernel_model(torch.from_numpy(a), torch.from_numpy(b))[0],
                 want)


@pytest.mark.parametrize("t", [1, 15, 16, 129, 512])
@pytest.mark.parametrize("d", [1, 31, 33, 300])
def test_plan_covers_every_step_and_channel_once(t, d):
    tiles, groups = lru.plan(t, d)
    assert (tiles - 1) * lru.WARPS * lru.STEPS < t <= \
        tiles * lru.WARPS * lru.STEPS
    assert (groups - 1) * lru.LANES < d <= groups * lru.LANES
    a, b = inputs((1, t, d), seed=3)
    _, stores = kernel_model(torch.from_numpy(a), torch.from_numpy(b))
    assert bool((stores == 1).all())


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    for name in ("WARPS", "STEPS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(lru, name), name
    assert lru.LANES == 32                       # one channel a lane


def test_work_at_the_path_case():
    """(4, 512, 2560) float32: a and b read and h written once, 3 x 4 x
    512 x 2560 x 4 = 62,914,560 bytes; a multiply and an add a step,
    2 x 5,242,880 = 10,485,760 operations."""
    ops, nbytes = lru.work(4, 512, 2560)
    assert nbytes == 62_914_560
    assert ops == 10_485_760
