"""The port's float kernels' plain versions against the JAX package, on
the CPU: `flash_attn`, `entropy_head` and `mlp_softmax_attn` of
`repro_torch.kernels.ref` (through the `kernels.ops` fronts, which take
the plain version for a CPU tensor) against `repro.kernels.ref` (the jnp
oracles) and against `repro.kernels.ops.*(impl="interpret")` (the Pallas
kernel bodies, run as tests/test_kernels.py runs them). The CUDA kernels
themselves are held against these plain versions on the card
(test_torch_kernels_gpu.py, chip_smoke.py).

Inputs come from numpy with a seed; everything is float32. A tolerance
`tol` bounds the largest absolute error by tol * max(1, max |want|), the
convention of tests/test_kernels.py: the attention outputs reach tens,
and summing in another order moves them by float32 rounding of that
size. Tolerances:
  * against the jnp oracle: 1e-5 for all three;
  * against the Pallas kernel: flash_attn 1e-5, entropy_head 1e-5,
    mlp_softmax_attn 1e-4 (the kernel reassociates probs @ V into
    relu(S W1 + b1) @ (W2 @ V) + b2 @ V);
  * entropy_head against the two entropy functions it stands in for —
    the target's and the clear engine's -sum p log(p + 1e-9) — 1e-5
    absolute: they differ by at most V * 1e-9 plus rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engine.clear import softmax_entropy as j_softmax_entropy
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.engine.clear import softmax_entropy
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

TOL = 1e-5


def assert_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(a)


def j(a):
    return jnp.asarray(a)


def attn_inputs(bh, sq, skv, dh, seed=0):
    return rand(seed, (bh, sq, dh)), rand(seed + 1, (bh, skv, dh)), \
        rand(seed + 2, (bh, skv, dh))


def msa_inputs(bh, s, dh, hid, seed=0):
    q, k, v = attn_inputs(bh, s, s, dh, seed)
    return (q, k, v, rand(seed + 3, (s, hid), 0.2), rand(seed + 4, (hid,), 0.1),
            rand(seed + 5, (hid, s), 0.2), rand(seed + 6, (s,), 0.01))


# ---------------------------------------------------------------------------
# flash_attn
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(2, 32, 32, 16), (1, 64, 64, 64), (3, 32, 64, 32)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES + [(2, 37, 37, 16)])
def test_flash_plain_matches_jax_ref(shape, causal):
    bh, sq, skv, dh = shape
    if causal and sq != skv:
        shape = (bh, sq, sq, dh)            # causal attention is square
    q, k, v = attn_inputs(*shape)
    want = np.asarray(j_ref.flash_attn(j(q), j(k), j(v), causal=causal))
    got = kops.flash_attn(t(q), t(k), t(v), causal=causal)
    assert got.dtype == torch.float32
    assert_close(got, want, TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_pallas_interpret(shape, causal):
    bh, sq, skv, dh = shape
    if causal and sq != skv:
        shape = (bh, sq, sq, dh)
    q, k, v = attn_inputs(*shape, seed=3)
    want = np.asarray(j_ops.flash_attn(j(q), j(k), j(v), causal=causal,
                                       impl="interpret", bq=16, bk=16))
    got = kops.flash_attn(t(q), t(k), t(v), causal=causal)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_grouped_kv_reads_the_group_head(causal):
    """k / v with BH / group rows: query row bh attends kv row bh // group,
    as repeating the kv rows would give."""
    q = rand(0, (6, 24, 16))
    k, v = rand(1, (2, 24, 16)), rand(2, (2, 24, 16))
    got = kops.flash_attn(t(q), t(k), t(v), causal=causal)
    rep = np.repeat(k, 3, axis=0), np.repeat(v, 3, axis=0)
    want = np.asarray(j_ref.flash_attn(j(q), j(rep[0]), j(rep[1]),
                                       causal=causal))
    assert_close(got, want, TOL)


def test_flash_front_counts_plain_calls():
    kops.reset_fa_stats()
    q, k, v = (t(a) for a in attn_inputs(1, 8, 8, 16))
    kops.flash_attn(q, k, v)
    kops.flash_attn(q, k, v, causal=False)
    assert kops.fa_stats() == {"kernel": 0, "ref": 2}


def test_flash_plain_rejects_ragged_causal():
    q, k, v = (t(a) for a in attn_inputs(1, 8, 12, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        kops.flash_attn(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# entropy_head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,v", [(16, 64), (32, 512), (64, 128), (16, 2),
                                 (5, 30522)])
def test_entropy_plain_matches_jax_ref(r, v):
    x = rand(r * v, (r, v), 3.0)
    want = np.asarray(j_ref.entropy_head(j(x)))
    got = kops.entropy_head(t(x))
    assert got.dtype == torch.float32 and got.shape == (r,)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("r,v", [(16, 64), (32, 512), (64, 128)])
def test_entropy_plain_matches_pallas_interpret(r, v):
    x = rand(r + v, (r, v), 3.0)
    want = np.asarray(j_ops.entropy_head(j(x), impl="interpret", br=16,
                                         bv=32))
    assert_close(kops.entropy_head(t(x)), want, TOL)


@pytest.mark.parametrize("v", [2, 4, 512])
@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_entropy_plain_is_within_v_eps_of_softmax_entropy(v, scale):
    """The kernel's function (m + log z - s/z, the exact entropy) against
    -sum p log(p + 1e-9): the JAX package's `engine/clear.softmax_entropy`
    and, identically, `core/target.prediction_entropy`'s formula; and the
    port's `softmax_entropy`. Different functions, |diff| <= V * 1e-9
    plus rounding: 1e-5 absolute."""
    x = rand(v, (32, v), scale)
    got = kops.entropy_head(t(x)).numpy()
    jax_se = np.asarray(j_softmax_entropy(j(x)))[:, 0]
    np.testing.assert_allclose(got, jax_se, atol=1e-5, rtol=0)
    port_se = softmax_entropy(t(x))[:, 0].numpy()
    np.testing.assert_allclose(got, port_se, atol=1e-5, rtol=0)


def test_entropy_front_counts_plain_calls():
    kops.reset_eh_stats()
    kops.entropy_head(t(rand(0, (4, 2))))
    assert kops.eh_stats() == {"kernel": 0, "ref": 1}


# ---------------------------------------------------------------------------
# mlp_softmax_attn
# ---------------------------------------------------------------------------

MSA_SHAPES = [(2, 32, 16, 4), (3, 64, 32, 8), (1, 128, 64, 16), (2, 64, 32, 2)]


@pytest.mark.parametrize("shape", MSA_SHAPES + [(2, 45, 16, 16)])
def test_msa_plain_matches_jax_ref(shape):
    args = msa_inputs(*shape)
    want = np.asarray(j_ref.mlp_softmax_attn(*map(j, args)))
    got = kops.mlp_softmax_attn(*map(t, args))
    assert got.dtype == torch.float32
    assert_close(got, want, TOL)


@pytest.mark.parametrize("shape", MSA_SHAPES)
def test_msa_plain_matches_pallas_interpret(shape):
    args = msa_inputs(*shape, seed=5)
    want = np.asarray(j_ops.mlp_softmax_attn(*map(j, args), impl="interpret",
                                             bq=16, bk=16))
    got = kops.mlp_softmax_attn(*map(t, args))
    assert_close(got, want, 1e-4)


def test_msa_plain_grouped_kv_reads_the_group_head():
    q, k, v, w1, b1, w2, b2 = msa_inputs(4, 16, 16, 4)
    k, v = k[:2], v[:2]
    got = kops.mlp_softmax_attn(*map(t, (q, k, v, w1, b1, w2, b2)))
    want = np.asarray(j_ref.mlp_softmax_attn(
        j(q), j(np.repeat(k, 2, 0)), j(np.repeat(v, 2, 0)), j(w1), j(b1),
        j(w2), j(b2)))
    assert_close(got, want, TOL)


def test_msa_reassociation_matches_materialized():
    """relu(S W1 + b1) @ (W2 V) + b2 V — the kernel's order, in torch —
    equals the plain materialized probs @ V: the identity the kernel
    rests on."""
    q, k, v, w1, b1, w2, b2 = map(t, msa_inputs(2, 32, 16, 4))
    s = q @ k.transpose(-1, -2) * 16 ** -0.5
    h = torch.relu(s @ w1 + b1)
    fused = h @ (w2 @ v) + (b2 @ v)[:, None]
    assert_close(fused, ref.mlp_softmax_attn(q, k, v, w1, b1, w2, b2)
                 .numpy(), 1e-4)


def test_msa_front_counts_plain_calls():
    kops.reset_msa_stats()
    kops.mlp_softmax_attn(*map(t, msa_inputs(1, 8, 16, 2)))
    assert kops.msa_stats() == {"kernel": 0, "ref": 1}
