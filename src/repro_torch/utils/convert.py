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


def _tensor(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same 16 bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy, device=None):
    """numpy-leaf tree -> the port's tensor tree, same structure and leaf
    order, each leaf a fresh copy on ``device`` (bfloat16 included)."""
    return tree_map(lambda a: _tensor(a).to(device), tree_of_numpy)


def params_to_numpy(tree):
    """Inverse of ``params_from_jax``: tensor tree -> numpy-leaf tree."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def transformer_params_from_jax(tree_of_numpy, cfg, device=None):
    """The JAX package's transformer params → the port's layout.

    JAX keeps ``head`` / ``blocks`` / ``tail``, with each ``blocks`` leaf
    stacked on a leading group axis (``blocks["sub<i>"]`` is sub-layer i of
    every group of ``cfg.block_pattern``); the port keeps one dict per
    layer in layer order under ``layers``. Top-level leaves (embed,
    final_norm, unembed) carry over as they are.
    """
    from repro_torch.models.transformer import layer_views

    views = layer_views(params_from_jax(tree_of_numpy, device), cfg)
    views["layers"] = [tree_map(lambda a: a.clone(), layer)
                       for layer in views["layers"]]
    return views


def train_state_from_jax(state_of_numpy, device=None):
    """The JAX package's training state (``local_sgd.init_state`` /
    ``StagewiseDriver`` state, as numpy) → the port's: ``params`` and
    ``opt`` leaf for leaf, ``step`` as an int and ``comm`` when present.

    The port trains in the reference's grouped layout
    (``models/transformer.py::to_grouped``), so every leaf — the stacked
    client replicas, the moments, the reducer's ``ref`` and residuals —
    carries over as it is, with ``params_from_jax``.
    """
    out = {"params": params_from_jax(state_of_numpy["params"], device),
           "opt": params_from_jax(state_of_numpy["opt"], device),
           "step": int(np.asarray(state_of_numpy["step"]))}
    if state_of_numpy.get("comm") is not None:
        out["comm"] = params_from_jax(state_of_numpy["comm"], device)
    return out
