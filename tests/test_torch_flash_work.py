"""flash_attn's work count (the operations and bytes its bound on the card
divides) against a brute-force count of the mask of the plain version
`ref.flash_attn`: with q = 0 every kept key gets the same weight and v =
I reads the weights back, so the nonzero outputs are the kept (query,
key) pairs. CPU only."""
import pytest
import torch

from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ref


def brute_pairs(sq, skv, causal, window, prefix_len=0):
    q = torch.zeros((1, sq, skv), dtype=torch.float64)
    k = torch.randn((1, skv, skv), dtype=torch.float64)
    v = torch.eye(skv, dtype=torch.float64)[None]
    out = ref.flash_attn(q, k, v, causal=causal, window=window,
                         prefix_len=prefix_len)
    return int((out > 0).sum())


CASES = [  # (Sq, Skv, causal, window)
    (48, 48, False, 0),        # non-causal
    (33, 70, False, 0),        # non-causal, Sq != Skv, ragged
    (64, 64, True, 0),         # causal
    (37, 37, True, 0),         # causal, ragged
    (50, 50, True, 7),         # window < S
    (50, 50, True, 80),        # window > S
    (37, 37, True, 37),        # window == S
    (130, 130, True, 64)]      # ragged, window of one key tile


@pytest.mark.parametrize("case", CASES)
def test_kept_pairs_match_the_plain_mask(case):
    sq, skv, causal, window = case
    assert fa.kept_pairs(sq, skv, causal, window) == \
        brute_pairs(sq, skv, causal, window)


PREFIX_CASES = [  # (S, prefix): none, one key, inside, = S, past S, and
    (50, 0), (50, 1), (50, 20), (37, 37), (37, 60),   # past a key tile
    (130, 70)]


@pytest.mark.parametrize("s,prefix", PREFIX_CASES)
def test_kept_pairs_with_a_prefix_match_the_plain_mask(s, prefix):
    """The prefix mask keeps sum over i of max(i + 1, min(P, S)) pairs."""
    assert fa.kept_pairs(s, s, True, 0, prefix) == \
        brute_pairs(s, s, True, 0, prefix) == \
        sum(max(i + 1, min(prefix, s)) for i in range(s))


def test_work_at_the_prefix_and_cross_path_shapes():
    """PaliGemma's prefill (32, 768, 256), group 8, prefix 256 and
    Whisper's cross-attention, 48 x 64 queries over 1,500 keys, bf16."""
    ops, nbytes = fa.work((32, 768, 256), 4, torch.bfloat16, True, 0, None,
                          256)
    assert ops == 4.0 * 32 * (256 * 256 + 768 * 769 // 2 - 256 * 257 // 2) \
        * 256
    assert nbytes == (2 * 32 + 2 * 4) * 768 * 256 * 2
    ops, nbytes = fa.work((48, 64, 64), 48, torch.bfloat16, False, 0, 1500)
    assert (ops, nbytes) == (4.0 * 48 * 64 * 1500 * 64,
                             (2 * 48 * 64 + 2 * 48 * 1500) * 64 * 2.0)


@pytest.mark.parametrize("dtype,esize", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
@pytest.mark.parametrize("case", CASES[:2] + CASES[4:6])
def test_work_counts_pairs_and_bytes(case, dtype, esize):
    sq, skv, causal, window = case
    bh, group, dh = 6, 3, 16
    ops, nbytes = fa.work((bh, sq, dh), bh // group, dtype, causal, window,
                          skv)
    assert ops == 4 * bh * brute_pairs(sq, skv, causal, window) * dh
    assert nbytes == (2 * bh * sq + 2 * (bh // group) * skv) * dh * esize


def test_work_at_the_path_shapes():
    """The two path cases' counts, as PERF.md states them."""
    ops, nbytes = fa.work((192, 512, 64), 192, torch.float32, False)
    assert (ops, nbytes) == (4.0 * 192 * 512 * 512 * 64,
                             4.0 * 192 * 512 * 64 * 4)
    ops, nbytes = fa.work((40, 512, 256), 4, torch.bfloat16, True, 2048)
    assert ops == 4.0 * 40 * (512 * 513 // 2) * 256
    assert nbytes == (2 * 40 + 2 * 4) * 512 * 256 * 2
