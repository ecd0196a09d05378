"""SyncPolicy — *when* to communicate.

A sync policy owns the stagewise schedule (η_s, T_s, k_s) and the
prox-center policy (whether the stage start re-centers the ^nc prox
surrogate). This is the paper's actual contribution factored into one
object: Algorithms 2/3 differ from Local SGD *only* in their SyncPolicy.

  EveryStep            k ≡ 1                       (SyncSGD and its batch
                                                    variants)
  FixedPeriod          k ≡ k₁                      (Local SGD, Alg. 1)
  StagewiseGeometric   η/2, T×2, k×2 (IID) | ×√2   (Alg. 2 / Alg. 3 Opt. 1)
  StagewiseLinear      η/s, T×s, k×s (IID) | ×√s   (Alg. 3 Opt. 2)

Policies are pure: ``stages(eta1, T1, k1, n_stages, iid)`` expands to the
concrete ``Stage`` list both execution backends consume, so the vmapped
simulator and the pjit driver provably run the same schedule. ``Stage`` and
the k-growth arithmetic live here (re-exported by ``core.schedules`` for
compatibility) so the engine layer has no dependency on ``repro_torch.core``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class Stage:
    """One stage of a stagewise schedule — the unit both execution
    backends consume. Units: ``T`` counts local iterations in the stage,
    ``k`` local steps between communication rounds (so the stage runs
    ⌈T/k⌉ rounds), ``eta`` is the stage learning rate η_s."""

    s: int          # 1-based stage index
    eta: float      # learning rate η_s
    T: int          # iterations in this stage
    k: int          # communication period (⌊k_s⌋, ≥ 1 — Alg. 2 line 2)
    k_raw: float    # un-floored k_s (the geometric/linear state variable)


def k_growth(iid: bool, geometric: bool, s: int) -> float:
    """Multiplier applied to k₁ (local steps per round) at stage s
    (1-based): 2^(s−1) / √2^(s−1) for the geometric schedules (Alg. 2 /
    Alg. 3 Opt. 1), s / √s for the linear one (Alg. 3 Opt. 2) — the IID
    variant in the numerator position, the Non-IID √ variant otherwise."""
    if geometric:
        return 2.0 ** (s - 1) if iid else math.sqrt(2.0) ** (s - 1)
    return float(s) if iid else math.sqrt(float(s))


@dataclass(frozen=True)
class SyncPolicy:
    """Base protocol. ``recenter`` is the prox-center policy: True means the
    prox surrogate re-centers at the averaged params at each stage start
    (Alg. 3); False means no center is ever produced.

    Two class-level capability flags route execution:
      ``asynchronous`` — rounds merge on arrival instead of barriering
        (honoured by the event runtime, not ported yet);
      ``adaptive`` — the k in each Stage is only a *cap*; the backend
        triggers a round when replica divergence crosses ``threshold``.
    """

    recenter: bool = False
    asynchronous = False  # class attribute, not a schedule parameter
    adaptive = False

    def stage(self, s: int, eta1: float, T1: int, k1: float,
              iid: bool) -> Stage:
        """Concrete stage s (1-based) from the initial (η₁, T₁, k₁) — η in
        learning-rate units, T in local iterations, k in steps/round."""
        raise NotImplementedError

    def stages(self, eta1: float, T1: int, k1: float, n_stages: int,
               iid: bool = True) -> List[Stage]:
        """Expand the full schedule both execution backends consume: the
        concrete Stage list for stages 1..n_stages."""
        return [self.stage(s, eta1, T1, k1, iid)
                for s in range(1, n_stages + 1)]


@dataclass(frozen=True)
class EveryStep(SyncPolicy):
    """k ≡ 1: communicate after every local step (SyncSGD / LB / CR-PSGD)."""

    def stage(self, s, eta1, T1, k1, iid):
        return Stage(s=s, eta=eta1, T=T1, k=1, k_raw=1.0)


@dataclass(frozen=True)
class FixedPeriod(SyncPolicy):
    """k ≡ k₁: Local SGD (Alg. 1) — identical stages, fixed period."""

    def stage(self, s, eta1, T1, k1, iid):
        return Stage(s=s, eta=eta1, T=T1, k=max(1, int(k1)), k_raw=k1)


@dataclass(frozen=True)
class StagewiseGeometric(SyncPolicy):
    """η_{s+1}=η_s/2, T_{s+1}=2T_s, k_{s+1}=2k_s (IID) or √2·k_s (Non-IID).

    Algorithm 2 (STL-SGD^sc) and Algorithm 3 Option 1 (with recenter=True).
    """

    def stage(self, s, eta1, T1, k1, iid):
        kr = k1 * k_growth(iid, True, s)
        return Stage(s=s, eta=eta1 / (2.0 ** (s - 1)), T=T1 * (2 ** (s - 1)),
                     k=max(1, int(kr)), k_raw=kr)


@dataclass(frozen=True)
class StagewiseLinear(SyncPolicy):
    """η_s=η₁/s, T_s=sT₁, k_s=sk₁ (IID) or √s·k₁ (Non-IID).

    Algorithm 3 Option 2 (STL-SGD^nc, linear growth).
    """

    def stage(self, s, eta1, T1, k1, iid):
        kr = k1 * k_growth(iid, False, s)
        return Stage(s=s, eta=eta1 / s, T=T1 * s,
                     k=max(1, int(kr)), k_raw=kr)


@dataclass(frozen=True)
class AsyncPeriod(SyncPolicy):
    """Barrier-free rounds: clients upload after k local steps *without*
    waiting for each other; the server merges each message on arrival with
    a staleness-decayed weight (``comm.StalenessWeightedMean``).

    The (η_s, T_s, k_s) schedule is delegated to ``base`` — any existing
    policy composes (``engine.make_async`` wraps a registered Algorithm), so
    e.g. STL-SGD's growing k_s runs with asynchronous merging unchanged.
    Only the event runtime (not ported yet) can execute the asynchronous
    semantics; the barrier backends reject it.
    """

    base: SyncPolicy = field(default_factory=FixedPeriod)
    asynchronous = True

    def stage(self, s, eta1, T1, k1, iid):
        return self.base.stage(s, eta1, T1, k1, iid)


@dataclass(frozen=True)
class AdaptivePeriod(SyncPolicy):
    """Divergence-triggered rounds (ROADMAP "adaptive/learned periods").

    η_s and T_s follow ``base``'s schedule; the Stage's k becomes a *cap*:
    between rounds the backend probes the replica divergence

        div = Σ_leaves mean_i ‖x_i − x̄‖² / (Σ_leaves ‖x̄‖² + ε)

    after every local step and triggers the communication round as soon as
    ``div ≥ threshold`` (or the cap is hit). Early stages sync often (large
    η ⇒ fast divergence); late stages stretch the period automatically —
    the data-driven analogue of the paper's hand-designed k_s growth.
    """

    base: SyncPolicy = field(default_factory=StagewiseGeometric)
    threshold: float = 3e-4
    adaptive = True

    def stage(self, s, eta1, T1, k1, iid):
        return self.base.stage(s, eta1, T1, k1, iid)
