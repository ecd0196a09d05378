"""Regularized surrogate objective for STL-SGD^nc (Alg. 3).

At stage s the subalgorithm minimizes
    f^γ_{x_s}(x) = f(x) + (1/2γ) ||x − x_s||²
with γ⁻¹ = 2ρ > ρ, which convexifies a ρ-weakly-convex f, so Theorem 1's
convex analysis applies within each stage.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves


def prox_loss(loss_fn, gamma_inv: float):
    """Wrap ``loss_fn(params, batch)`` into f^γ with center passed at call time.

    Returns ``fn(params, batch, center)``; ``gamma_inv == 0`` disables the term
    (plain Local SGD subproblem, used by STL-SGD^sc).
    """
    if gamma_inv == 0.0:
        def fn(params, batch, center):
            return loss_fn(params, batch)
        return fn

    def fn(params, batch, center):
        base = loss_fn(params, batch)
        sq = sum(
            torch.sum(torch.square((p - c).to(torch.float32)))
            for p, c in zip(tree_leaves(params), tree_leaves(center))
        )
        return base + 0.5 * gamma_inv * sq

    return fn
