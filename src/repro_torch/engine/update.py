"""LocalUpdate — *how* each client steps between communication rounds.

The per-client update rule. A LocalUpdate owns the round's minibatch
policy (size, growth, per-example weighting) while the optimizer
arithmetic stays in the round function — so LB-SGD and CR-PSGD are
*update rules*, not special cases of the driver loop.

  SgdUpdate          fixed batch B (the paper's default)
  LargeBatchUpdate   B ×= factor, meant to pair with EveryStep (LB-SGD)
  GrowingBatchUpdate CR-PSGD [38]: batch grows geometrically per iteration,
                     realised as a masked fixed-size buffer with per-example
                     weights so every step has the same shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class LocalUpdate:
    """Base rule: fixed batch, unweighted loss."""

    name = "sgd"

    def round_batch(self, cfg) -> int:
        """Per-client minibatch buffer size for this run."""
        return cfg.batch_per_client

    def growth(self, cfg) -> float:
        """Per-iteration batch growth factor (1.0 = fixed batch)."""
        return 1.0

    def make_loss(self, ploss):
        """Wrap a (params, batch, center) loss into the 4-arg
        (params, batch, center, weights) form the round function calls.
        The base rule ignores the weights (uniform minibatch mean)."""
        return lambda params, batch, center, weights: ploss(
            params, batch, center)


@dataclass(frozen=True)
class SgdUpdate(LocalUpdate):
    pass


@dataclass(frozen=True)
class LargeBatchUpdate(LocalUpdate):
    """LB-SGD: k=1 with an inflated per-step batch."""

    factor: int = 4
    name = "large_batch"

    def round_batch(self, cfg) -> int:
        return cfg.batch_per_client * self.factor


@dataclass(frozen=True)
class GrowingBatchUpdate(LocalUpdate):
    """CR-PSGD: batch bt = min(max_batch, b0·ρ^t), masked into a fixed
    buffer. The loss is a per-example weighted sum so masked slots
    contribute exactly zero."""

    name = "growing_batch"

    def round_batch(self, cfg) -> int:
        return cfg.max_batch

    def growth(self, cfg) -> float:
        return cfg.batch_growth

    def make_loss(self, ploss):
        def wloss(params, batch, center, weights):
            per = torch.func.vmap(
                lambda x: ploss(params, tree_map(lambda a: a[None], x),
                                center)
            )(batch)
            return torch.sum(per * weights)

        return wloss
