"""Carry parameter trees across between the JAX package and the port.

Both packages use dict/list trees in one layout (``x @ w`` with w as
(d_in, d_out)), so a weight converts leaf by leaf. The JAX side hands over
numpy arrays (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_jax(tree_of_numpy, device=None):
    """numpy-leaf tree -> the port's tensor tree, same structure and leaf
    order, each leaf a fresh copy on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True))
                    .to(device), tree_of_numpy)


def params_to_numpy(tree):
    """Inverse of ``params_from_jax``: tensor tree -> numpy-leaf tree."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
