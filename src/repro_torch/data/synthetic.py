"""Synthetic datasets (no downloads), as numpy arrays.

``make_binary_classification`` mimics the paper's a9a / MNIST-binary setup
(sparse features, labels in {−1, +1}). It is the same numpy recipe as the
JAX package's ``data/synthetic.py``, so one seed gives one dataset in
both packages.
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
