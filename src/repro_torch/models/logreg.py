"""L2-regularized logistic regression — the paper's §5.1 convex problem.

    min_θ (1/n) Σ log(1 + exp(-y_i x_iᵀθ)) + (λ/2)||θ||²   (Eq. 7)

λ > 0 makes this λ-strongly convex; the paper sets λ = 1/n. Parameters are
a dict tree in the JAX package's layout: ``{"theta": (d,)}``.
"""
from __future__ import annotations

import torch


def softplus(x):
    """log(1 + e^x) as ``logaddexp(x, 0)`` — the JAX package's
    ``jax.nn.softplus``, gradient ``exp(x − softplus(x))`` included."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_params(n_features: int, device=None):
    return {"theta": torch.zeros((n_features,), dtype=torch.float32,
                                 device=device)}


def loss_fn(params, batch, lam: float):
    """batch: {"x": (B, d), "y": (B,) in {-1, +1}}."""
    margin = batch["y"] * (batch["x"] @ params["theta"])
    data_loss = torch.mean(softplus(-margin))
    reg = 0.5 * lam * torch.sum(torch.square(params["theta"]))
    return data_loss + reg


def full_objective(params, x, y, lam: float):
    return loss_fn(params, {"x": x, "y": y}, lam)


def accuracy(params, x, y):
    pred = torch.sign(x @ params["theta"])
    return torch.mean((pred == y).to(torch.float32))
