"""Stagewise schedules — the heart of STL-SGD (Algorithms 2 & 3).

A ``Stage`` bundles (η_s, T_s, k_s). Schedules produce stages:

  stl_sc / stl_nc1 (geometric, Alg. 2 & Alg. 3 Option 1):
      η_{s+1} = η_s / 2,   T_{s+1} = 2 T_s,
      k_{s+1} = 2 k_s (IID)   |   √2 k_s (Non-IID)

  stl_nc2 (linear, Alg. 3 Option 2):
      η_s = η_1 / s,   T_s = s T_1,
      k_s = s k_1 (IID)   |   √s k_1 (Non-IID)

  local (fixed k), sync (k = 1): single-stage degenerate schedules.

``theory_k1`` gives the paper's admissible initial period (Thm. 1/2):
      IID:     k₁ = min( 1/(6 η₁ L N),  1/(9 η₁ L) )
      Non-IID: k₁ = min( σ/√(6 η₁ L N (σ² + 4 ζ*)),  1/(9 η₁ L) )

and ``comm_rounds`` computes Σ_s T_s / k_s — the quantity Tables 1–3 count.

``Stage``, ``k_growth`` and the schedule expansion now live in the
``repro_torch.engine`` SyncPolicy layer (each policy owns its η_s/T_s/k_s rule);
this module re-exports them and keeps ``make_stages(algo, ...)`` as the
name-based convenience wrapper over the algorithm registry.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.engine.policy import Stage, k_growth  # noqa: F401  (re-export)


def theory_k1(eta1: float, L: float, N: int, sigma: float = 1.0,
              zeta: float = 0.0, iid: bool = True) -> float:
    """Paper's initial communication period (Theorem 1 / 2 / 3)."""
    if iid:
        return min(1.0 / (6.0 * eta1 * L * N), 1.0 / (9.0 * eta1 * L))
    denom = math.sqrt(6.0 * eta1 * L * N * (sigma ** 2 + 4.0 * zeta))
    return min(sigma / denom, 1.0 / (9.0 * eta1 * L))


def make_stages(algo: str, eta1: float, T1: int, k1: float, n_stages: int,
                iid: bool = True) -> List[Stage]:
    """Expand a registered algorithm's SyncPolicy into concrete stages."""
    from repro_torch.engine.algorithm import get_algorithm

    return get_algorithm(algo).sync_policy.stages(eta1, T1, k1, n_stages, iid)


def comm_rounds(stages: List[Stage]) -> int:
    """Total communication rounds Σ_s ceil(T_s / k_s)."""
    return sum(math.ceil(st.T / st.k) for st in stages)


def total_iters(stages: List[Stage]) -> int:
    return sum(st.T for st in stages)


def min_stages_sc(N: int, f_gap0: float, eta1: float, sigma: float) -> int:
    """Theorem 2's stage-count condition: S ≥ log(N·Δ₀/(η₁σ²)) + 2."""
    val = max(N * f_gap0 / max(eta1 * sigma ** 2, 1e-30), 1.0)
    return int(math.ceil(math.log2(val))) + 2


def predicted_complexity(algo: str, N: int, T: int, iid: bool) -> float:
    """Closed-form communication-complexity orders from Table 3 (up to consts).

    Used by benchmarks/table3 to cross-check measured Σ T_s/k_s scaling.
    """
    if algo == "sync":
        return float(T)
    if algo in ("stl_sc", "stl_nc1"):
        return N * math.log(max(T, 2)) if iid else math.sqrt(N) * math.sqrt(T)
    if algo == "stl_nc2":
        return N ** 1.5 * math.sqrt(T) if iid else N ** 0.75 * T ** 0.75
    if algo == "local":
        return N ** 1.5 * math.sqrt(T) if iid else N ** 0.75 * T ** 0.75
    raise ValueError(algo)
