"""Client data partitioners (numpy).

``partition_paper`` reproduces the paper's §5 Non-IID construction: take s%
of the data i.i.d. and split it equally across clients; sort the remaining
(100−s)% by class label and deal it out to clients in order. s=50 for the
convex experiments, s=0 for the non-convex ones. Same recipes as the JAX
package's ``data/partition.py``.
"""
from __future__ import annotations

import numpy as np


def partition_iid(x, y, n_clients: int, seed: int = 0):
    """Random equal split. Returns dict with leading client axis."""
    rng = np.random.RandomState(seed)
    n = len(y)
    per = n // n_clients
    idx = rng.permutation(n)[: per * n_clients].reshape(n_clients, per)
    return {"x": np.asarray(x)[idx], "y": np.asarray(y)[idx]}


def partition_paper(x, y, n_clients: int, iid_percent: float, seed: int = 0):
    """The paper's split: iid_percent% random + rest label-sorted, dealt in order."""
    rng = np.random.RandomState(seed)
    x, y = np.asarray(x), np.asarray(y)
    n = len(y)
    per = n // n_clients
    usable = per * n_clients
    perm = rng.permutation(n)[:usable]
    n_iid = int(usable * iid_percent / 100.0)
    n_iid -= n_iid % n_clients  # keep equal shares
    iid_idx = perm[:n_iid]
    rest = perm[n_iid:]
    rest = rest[np.argsort(y[rest], kind="stable")]  # label-sorted block

    iid_shares = iid_idx.reshape(n_clients, -1) if n_iid else np.zeros((n_clients, 0), int)
    rest_shares = rest.reshape(n_clients, -1)
    idx = np.concatenate([iid_shares, rest_shares], axis=1)
    return {"x": x[idx], "y": y[idx]}
