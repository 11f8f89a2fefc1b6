"""Synthetic classification tasks for the selection experiments — a copy
of repro/data/tasks.py (numpy only), since the port imports nothing of
the JAX package. The same seed gives the same arrays.

Mirrors the paper's data premise (§2.1): the candidate pool is UNLABELED
and class-IMBALANCED. Each class c has a token unigram distribution
(peaked on a class-specific subset of the vocabulary) plus class-neutral
noise tokens; sequences are sampled per-class. Imbalance removes most
minority-class examples from the pool — exactly the regime where
entropy-based selection beats random (the model is least confident on
under-represented classes, so selection re-balances the training set).

The pool also contains a REDUNDANT slab: near-duplicate easy examples of
the majority class (paper §1: "datasets are often redundant and noisy").
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClassTask:
    pool_tokens: np.ndarray      # (N, S) int32 — unlabeled candidates
    pool_labels: np.ndarray      # (N,) hidden labels (owner-side only)
    test_tokens: np.ndarray
    test_labels: np.ndarray
    n_classes: int
    vocab: int


def make_classification_task(seed: int, *, n_pool: int = 2000,
                             n_test: int = 500, seq: int = 16,
                             vocab: int = 512, n_classes: int = 4,
                             imbalance: float = 8.0,
                             signal: float = 0.75,
                             redundancy: float = 0.3) -> ClassTask:
    """imbalance: majority/minority prior ratio; signal: fraction of
    class-informative tokens per sequence; redundancy: fraction of the
    pool replaced by near-duplicate majority examples."""
    rng = np.random.default_rng(seed)
    toks_per_class = vocab // (n_classes + 1)
    class_tokens = [np.arange(c * toks_per_class, (c + 1) * toks_per_class)
                    for c in range(n_classes)]
    noise_tokens = np.arange(n_classes * toks_per_class, vocab)

    def sample(label: int, n: int) -> np.ndarray:
        informative = rng.choice(class_tokens[label], size=(n, seq))
        noise = rng.choice(noise_tokens, size=(n, seq))
        take = rng.random((n, seq)) < signal
        return np.where(take, informative, noise).astype(np.int32)

    # geometric class priors: p(c) ~ imbalance^{-c/(C-1)}
    w = imbalance ** (-np.arange(n_classes) / max(n_classes - 1, 1))
    priors = w / w.sum()

    pool_labels = rng.choice(n_classes, size=n_pool, p=priors)
    pool_tokens = np.concatenate([sample(int(y), 1) for y in pool_labels])
    # redundant slab: near-duplicates of one majority example
    n_red = int(redundancy * n_pool)
    if n_red:
        proto = sample(0, 1)[0]
        dup = np.tile(proto, (n_red, 1))
        flip = rng.random(dup.shape) < 0.05
        dup = np.where(flip, rng.integers(0, vocab, dup.shape), dup)
        idx = rng.choice(n_pool, size=n_red, replace=False)
        pool_tokens[idx] = dup
        pool_labels[idx] = 0

    test_labels = rng.integers(0, n_classes, size=n_test)   # balanced test
    test_tokens = np.concatenate([sample(int(y), 1) for y in test_labels])
    return ClassTask(pool_tokens, pool_labels.astype(np.int32),
                     test_tokens, test_labels.astype(np.int32),
                     n_classes, vocab)
