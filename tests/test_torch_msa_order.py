"""The arithmetic of the mlp_softmax_attn kernel (csrc/mlp_softmax_attn.cu),
on the CPU, against the plain versions: the port's `kernels.ref`, the JAX
package's jnp oracle `repro.kernels.ref` and its Pallas kernel in
interpret mode (run as tests/test_torch_clear_kernels.py runs it).

The kernel never forms a score. It computes A = scale K^T W1 first, one
thread-block cluster a q head: the cluster's C blocks (`msa.plan`) each
reduce the partial A_r over their slice of L key rows, ragged rows
zero-filled, and every block sums A_0 ... A_{C-1} in rank order before
H = relu(Q A + b1) and out = H U + u0, with U = W2 V and u0 = b2 V from
the wrapper's two products. `kernel_model` below is that arithmetic in
plain torch, float32: a model for this test that runs on no path.

Tolerance: 1e-4 of max(1, max |want|), the tolerance the kernel is held
to on the card. The model reassociates both products of the
materialized form (S W1 = Q (K^T W1), probs V = H (W2 V) + b2 V), so its
float32 sums run over other terms in another order; the outputs reach
hundreds at the path's scales, and the rounding of those sums is of
that size. `msa.work` is checked against a count written out by hand at
the clear sieve's phase-2 case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import mlp_softmax_attn as msa
from repro_torch.kernels import ref

TOL = 1e-4


def inputs(bh, sq, skv, dh, hid, group=1, seed=0):
    """q, k, v, w1, b1, w2, b2 at chip_smoke.py phase 2's scales."""
    rng = np.random.default_rng(seed)

    def randn(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (randn((bh, sq, dh)), randn((bh // group, skv, dh)),
            randn((bh // group, skv, dh)), randn((skv, hid), 0.2),
            randn((hid,), 0.1), randn((hid, skv), 0.2), randn((skv,), 0.01))


def kernel_model(q, k, v, w1, b1, w2, b2):
    """The kernel's order of operations, in float32."""
    bh, sq, dh = q.shape
    bhk, skv, _ = k.shape
    group, hid = bh // bhk, w1.shape[1]
    nc, slice_ = msa.plan(sq, skv)
    scale = dh ** -0.5
    u, u0 = w2 @ v, b2 @ v                   # (BHk, hid, Dh), (BHk, Dh)
    out = torch.empty_like(q)
    for h in range(bh):
        kv = h // group
        a = torch.zeros((dh, hid))
        for r in range(nc):                               # rank order
            rows = range(r * slice_, min(skv, (r + 1) * slice_))
            kr, wr = torch.zeros((slice_, dh)), torch.zeros((slice_, hid))
            kr[:len(rows)] = k[kv, rows.start:rows.stop]
            wr[:len(rows)] = w1[rows.start:rows.stop]
            a = a + (kr.T @ wr) * scale
        hh = torch.relu(q[h] @ a + b1)
        out[h] = hh @ u[kv] + u0[kv]
    return out


def assert_close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# (BH, Sq, Skv, Dh, hid, group): the clear sieve's phase-2 case at BH 2,
# phase 1's hid 2, a ragged S, Sq != Skv both ways, Sq 1024 (two query
# tiles a block), Sq 1 (a cluster of one), Skv not a multiple of C 64,
# hid 64 at Dh 128, and grouped kv heads
CASES = {"path phase 2": (2, 512, 512, 64, 16, 1),
         "path phase 1": (2, 512, 512, 64, 2, 1),
         "ragged S": (3, 100, 100, 64, 16, 1),
         "Sq < Skv": (2, 130, 300, 32, 8, 1),
         "Sq > Skv": (2, 300, 70, 16, 4, 1),
         "Sq 1024": (1, 1024, 200, 16, 4, 1),
         "Sq 1": (2, 1, 100, 64, 16, 1),
         "Sq 8": (2, 8, 8, 32, 3, 1),
         "Skv not a multiple of C 64": (2, 512, 450, 32, 5, 1),
         "hid 64 Dh 128": (1, 64, 64, 128, 64, 1),
         "group 2": (4, 100, 100, 16, 4, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_plain(case):
    args = [torch.from_numpy(x) for x in inputs(*CASES[case])]
    assert_close(kernel_model(*args), ref.mlp_softmax_attn(*args))


@pytest.mark.parametrize("case", ["path phase 2", "path phase 1",
                                  "ragged S", "Sq < Skv", "Sq 1"])
def test_kernel_model_matches_jax_oracle(case):
    x = inputs(*CASES[case])
    want = np.asarray(j_ref.mlp_softmax_attn(*map(jnp.asarray, x)))
    assert_close(kernel_model(*map(torch.from_numpy, x)), want)


# Pallas tiles must divide Sq and Skv: (BH, Sq, Skv, Dh, hid), bq, bk
@pytest.mark.parametrize("shape,bq,bk", [((2, 512, 512, 64, 16), 128, 128),
                                         ((2, 512, 512, 64, 2), 128, 128),
                                         ((2, 64, 192, 32, 8), 64, 64)])
def test_kernel_model_matches_pallas_interpret(shape, bq, bk):
    x = inputs(*shape, seed=5)
    want = np.asarray(j_ops.mlp_softmax_attn(*map(jnp.asarray, x),
                                             impl="interpret", bq=bq, bk=bk))
    assert_close(kernel_model(*map(torch.from_numpy, x)), want)


@pytest.mark.parametrize("sq", [1, 8, 100, 512, 1024])
@pytest.mark.parametrize("skv", [1, 8, 100, 450, 512, 1000])
def test_plan_covers_every_key_row_and_query_tile_once(sq, skv):
    nc, slice_ = msa.plan(sq, skv)
    assert 1 <= nc <= msa.CLUSTER_MAX
    rows = [j for r in range(nc)
            for j in range(r * slice_, min(skv, (r + 1) * slice_))]
    assert sorted(rows) == rows == list(range(skv))
    nq = -(-sq // msa.BQ)
    tiles = sorted(t for r in range(nc) for t in range(r, nq, nc))
    assert tiles == list(range(nq))
    assert nc == min(nq, msa.CLUSTER_MAX)


def test_work_at_the_path_case():
    """(48, 512, 64), hid 16, float32: q, k, v and out 4 x 48 x 512 x 64
    float32; w1, w2 512 x 16, b1 16 and b2 512 float32. A, q A and H U
    2 x 48 x 512 x 64 x 16 each, [w2 ; b2] @ v 2 x 48 x 17 x 512 x 64."""
    nbytes, ops = msa.work(48, 1, 512, 512, 64, 16, torch.float32)
    assert nbytes == 4 * 48 * 512 * 64 * 4 + 2 * 512 * 16 * 4 + 16 * 4 \
        + 512 * 4 == 25_233_472
    assert ops == 3 * 2 * 48 * 512 * 64 * 16 + 2 * 48 * 17 * 512 * 64 \
        == 204_472_320
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.00753, abs=1e-5)
    # grouped kv heads read k and v, and reduce A and U, once a kv head
    nb2, ops2 = msa.work(48, 2, 512, 512, 64, 16, torch.bfloat16)
    assert nb2 == (2 * 48 + 2 * 24) * 512 * 64 * 2 + 2 * 512 * 16 * 4 \
        + 16 * 4 + 512 * 4
    assert ops2 == 2.0 * (24 * 512 * 64 * 16 + 2 * 48 * 512 * 64 * 16
                          + 24 * 17 * 512 * 64)
