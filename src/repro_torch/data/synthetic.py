"""Synthetic datasets (no downloads), as numpy arrays.

``make_binary_classification`` mimics the paper's a9a / MNIST-binary setup
(sparse features, labels in {−1, +1}); ``make_multiclass_images`` mimics
CIFAR-10 (32×32×3, 10 classes) for the non-convex experiments;
``make_token_stream`` produces LM token shards with per-client Zipf skew
for language-model training, and ``batch_iterator`` windows over one. All
are the same numpy recipes as the JAX package's ``data/synthetic.py``, so
one seed gives one dataset in both packages.
"""
from __future__ import annotations

import numpy as np


def make_binary_classification(n: int = 32561, d: int = 123, seed: int = 0,
                               noise: float = 0.4, sparsity: float = 0.9):
    """a9a-like: sparse binary-ish features, {-1,+1} labels from a noisy halfspace."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, d) > sparsity).astype(np.float32)
    x *= rng.rand(n, d).astype(np.float32) + 0.5
    w_true = rng.randn(d).astype(np.float32)
    margin = x @ w_true + noise * rng.randn(n).astype(np.float32)
    y = np.where(margin > np.median(margin), 1.0, -1.0).astype(np.float32)
    return x, y


def make_multiclass_images(n: int = 10000, n_classes: int = 10, hw: int = 32,
                           seed: int = 0):
    """CIFAR-like: class-conditional Gaussian blobs + structured noise.
    Returns x (n, hw, hw, 3) float32 (NHWC) and y (n,) int32."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n)
    protos = rng.randn(n_classes, hw, hw, 3).astype(np.float32)
    x = 0.6 * protos[y] + 0.8 * rng.randn(n, hw, hw, 3).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def make_token_stream(n_tokens: int, vocab: int, n_clients: int, seed: int = 0,
                      non_iid: bool = False):
    """Token shards (n_clients, n_tokens) int32 — Zipf-ish unigram LM data.

    Non-IID: each client samples from a different random permutation of the
    Zipf distribution (distinct head vocabulary per client).
    """
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1)
    base_p = 1.0 / ranks
    base_p /= base_p.sum()
    shards = []
    for c in range(n_clients):
        p = base_p if not non_iid else base_p[rng.permutation(vocab)]
        shards.append(rng.choice(vocab, size=n_tokens, p=p))
    return np.stack(shards).astype(np.int32)


def batch_iterator(tokens, batch: int, seq_len: int, seed: int = 0):
    """Yield (tokens, labels) windows from a flat token shard."""
    rng = np.random.RandomState(seed)
    n = tokens.shape[-1] - seq_len - 1
    while True:
        starts = rng.randint(0, n, size=batch)
        xs = np.stack([tokens[..., s: s + seq_len] for s in starts])
        ys = np.stack([tokens[..., s + 1: s + seq_len + 1] for s in starts])
        yield xs, ys
