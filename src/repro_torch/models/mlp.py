"""Small multi-layer perceptron — the multi-leaf streaming-reduce testbed.

Same binary-classification problem as ``models.logreg`` (batch =
``{"x": (B, d), "y": (B,) in {-1, +1}}``, L2-regularized logistic loss)
with a parameter *tree*: ``depth`` equal-width tanh hidden layers plus a
linear head, 2·(depth + 1) leaves. The layout is the JAX package's —
``{"layers": [{"w": (d_in, width), "b": (width,)}, …], "out": {"w", "b"}}``
with ``h @ w`` — so its weights carry across unchanged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.logreg import softplus
from repro_torch.utils.tree import tree_leaves


def init_params(n_features: int, width: int = 96, depth: int = 3, *,
                seed: int = 0, device=None):
    """He-initialized MLP params from a seeded ``torch.Generator`` (the
    JAX package draws its own with ``jax.random``; carry those across with
    ``utils.convert.params_from_jax`` to start both from one point)."""
    g = torch.Generator().manual_seed(seed)

    def he(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=g, dtype=torch.float32)
        return (w * math.sqrt(2.0 / d_in)).to(device)

    layers = []
    d_in = n_features
    for _ in range(depth):
        layers.append({"w": he(d_in, width),
                       "b": torch.zeros((width,), dtype=torch.float32,
                                        device=device)})
        d_in = width
    head = {"w": he(d_in, 1),
            "b": torch.zeros((1,), dtype=torch.float32, device=device)}
    return {"layers": layers, "out": head}


def forward(params, x):
    """Per-example logit: tanh MLP over (B, d) features -> (B,)."""
    h = x
    for lyr in params["layers"]:
        h = torch.tanh(h @ lyr["w"] + lyr["b"])
    return (h @ params["out"]["w"] + params["out"]["b"])[:, 0]


def loss_fn(params, batch, lam: float):
    """Mean logistic loss + (λ/2)·||params||² (all leaves)."""
    margin = batch["y"] * forward(params, batch["x"])
    data_loss = torch.mean(softplus(-margin))
    reg = 0.5 * lam * sum(torch.sum(torch.square(l))
                          for l in tree_leaves(params))
    return data_loss + reg


def full_objective(params, x, y, lam: float):
    return loss_fn(params, {"x": x, "y": y}, lam)


def accuracy(params, x, y):
    pred = torch.sign(forward(params, x))
    return torch.mean((pred == y).to(torch.float32))
