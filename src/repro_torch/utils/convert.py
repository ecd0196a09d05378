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


def transformer_params_from_jax(tree_of_numpy, cfg, device=None):
    """The JAX package's transformer params → the port's layout.

    JAX keeps ``head`` / ``blocks`` / ``tail``, with each ``blocks`` leaf
    stacked on a leading group axis (``blocks["sub<i>"]`` is sub-layer i of
    every group of ``cfg.block_pattern``); the port keeps one dict per
    layer in layer order under ``layers``. Top-level leaves (embed,
    final_norm, unembed) carry over as they are.
    """
    from repro_torch.models.transformer import _plan

    head_kinds, n_groups, pattern, tail_kinds = _plan(cfg)
    t = params_from_jax(tree_of_numpy, device)
    out = {k: v for k, v in t.items() if k not in ("head", "blocks", "tail")}
    layers = list(t["head"])
    for g in range(n_groups):
        for i in range(len(pattern)):
            layers.append(tree_map(lambda a: a[g].clone(),
                                   t["blocks"][f"sub{i}"]))
    layers += list(t["tail"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: JAX tree holds {len(layers)} layers, "
                         f"config says {cfg.n_layers}")
    out["layers"] = layers
    return out
