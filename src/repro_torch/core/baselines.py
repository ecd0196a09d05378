"""Baseline drivers the paper compares against (§5): SyncSGD, LB-SGD, CR-PSGD.

The port of ``src/repro/core/baselines.py``. All three are degenerate
Algorithms in the ``engine`` registry — the ``EveryStep`` sync policy
(k = 1) with different ``LocalUpdate`` batch rules — so the baselines
share every line of the driver with STL-SGD. CR-PSGD's growing batch is
realised by the data pipeline (``crpsgd_batch_sizes``), keeping the step
shape-stable per size.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import TrainConfig
from repro_torch.core.stl_sgd import StagewiseDriver


def sync_sgd_driver(tcfg: TrainConfig, train_step, sync_step) -> StagewiseDriver:
    return StagewiseDriver(dataclasses.replace(tcfg, algo="sync"),
                           train_step, sync_step)


def lb_sgd_driver(tcfg: TrainConfig, train_step, sync_step) -> StagewiseDriver:
    return StagewiseDriver(dataclasses.replace(tcfg, algo="lb"),
                           train_step, sync_step)


def crpsgd_batch_sizes(b0: int, growth: float, n_steps: int, max_batch: int,
                       quantum: int = 8) -> List[int]:
    """CR-PSGD batch schedule, quantised to multiples of ``quantum`` so the
    number of distinct step shapes stays small."""
    sizes = []
    b = float(b0)
    for _ in range(n_steps):
        q = min(max_batch, int(b / quantum + 0.5) * quantum or quantum)
        sizes.append(max(quantum, q))
        b = min(float(max_batch), b * growth)
    return sizes
