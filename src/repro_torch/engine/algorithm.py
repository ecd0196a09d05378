"""Algorithm = SyncPolicy × LocalUpdate × prox flag, plus the registry.

An ``Algorithm`` is the declarative description of one training method:
*when* to communicate (SyncPolicy), *how* each client steps between rounds
(LocalUpdate), and whether the loss is the ^nc prox surrogate re-centered
per stage. Both execution backends (the vmapped simulator and the pjit
stagewise driver) consume Algorithms — no string dispatch survives below
this layer.

The registry keeps the seven paper names working everywhere a config or CLI
says ``algo="stl_sc"``:

  sync     SyncSGD                      EveryStep            + SgdUpdate
  lb       Large-batch SyncSGD          EveryStep            + LargeBatch
  crpsgd   CR-PSGD [38]                 EveryStep            + GrowingBatch
  local    Local SGD (Alg. 1)           FixedPeriod          + SgdUpdate
  stl_sc   STL-SGD^sc (Alg. 2)          StagewiseGeometric   + SgdUpdate
  stl_nc1  STL-SGD^nc Opt. 1 (Alg. 3)   StagewiseGeometric*  + SgdUpdate
  stl_nc2  STL-SGD^nc Opt. 2 (Alg. 3)   StagewiseLinear*     + SgdUpdate
                                        (* prox, re-centered per stage)

``register`` is open: new methods plug in without touching the engine or
any front-end. Two registry extensions ship with the runtime subsystem:

  adaptive  divergence-triggered periods    AdaptivePeriod(StagewiseGeo)
  <name>+async  any registered name wrapped in AsyncPeriod (barrier-free
                merge-on-arrival rounds; executed by runtime.EventBackend)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.engine.policy import (
    AdaptivePeriod,
    AsyncPeriod,
    EveryStep,
    FixedPeriod,
    Stage,
    StagewiseGeometric,
    StagewiseLinear,
    SyncPolicy,
)
from repro_torch.engine.update import (
    GrowingBatchUpdate,
    LargeBatchUpdate,
    LocalUpdate,
    SgdUpdate,
)


@dataclass(frozen=True)
class Algorithm:
    """One training method, declaratively: *when* to communicate
    (``sync_policy`` — the (η_s, T_s, k_s) stage schedule, T_s in local
    iterations, k_s in local steps between rounds), *how* clients step
    between rounds (``local_update`` — the minibatch size/growth rule),
    and whether the loss is the ^nc prox surrogate f^γ re-centered at
    each stage start (``prox``, active only when cfg.gamma_inv > 0).
    Resolved by name through the registry (``get_algorithm``); consumed
    unchanged by all three execution backends."""

    name: str
    sync_policy: SyncPolicy
    local_update: LocalUpdate = field(default_factory=SgdUpdate)
    # ^nc prox surrogate f^γ — active only when cfg.gamma_inv > 0
    prox: bool = False

    def stages(self, cfg) -> List[Stage]:
        """Concrete (η_s, T_s, k_s) stage list for a TrainConfig."""
        return self.sync_policy.stages(cfg.eta1, cfg.T1, cfg.k1,
                                       cfg.n_stages, cfg.iid)

    def uses_center(self, cfg) -> bool:
        """Whether runs re-center a prox term at each stage start."""
        return self.prox and cfg.gamma_inv > 0.0

    def gamma_inv(self, cfg) -> float:
        """Effective prox strength 1/γ (0.0 when the method has no prox
        term or the config disables it)."""
        return cfg.gamma_inv if self.uses_center(cfg) else 0.0


_REGISTRY: Dict[str, Algorithm] = {}


def register(algorithm: Algorithm, *, overwrite: bool = False) -> Algorithm:
    """Add an Algorithm to the registry under its ``name``.

    Every front-end (simulator, driver, runtime, benchmarks, CLI) resolves
    ``cfg.algo`` strings through this registry, so a registered method is
    immediately runnable everywhere — no engine or front-end edits. Raises
    on duplicate names unless ``overwrite=True``; returns the algorithm
    for decorator-style use.
    """
    if algorithm.name in _REGISTRY and not overwrite:
        raise ValueError(f"algorithm {algorithm.name!r} already registered")
    _REGISTRY[algorithm.name] = algorithm
    return algorithm


def get_algorithm(name) -> Algorithm:
    """Resolve an algorithm by registry name (Algorithm passes through).

    Any registered name composes with barrier-free merging via the
    ``"<name>+async"`` suffix — e.g. ``get_algorithm("stl_sc+async")`` wraps
    STL-SGD^sc's schedule in an ``AsyncPeriod`` policy (see ``make_async``).
    """
    if isinstance(name, Algorithm):
        return name
    if isinstance(name, str) and name.endswith("+async"):
        return make_async(get_algorithm(name[: -len("+async")]))
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm: {name!r} (known: {algorithm_names()})"
        ) from None


def make_async(algorithm) -> Algorithm:
    """Wrap an Algorithm's SyncPolicy in ``AsyncPeriod`` (idempotent).

    The schedule, local update and prox flag are preserved; only the round
    semantics change from barriered average to merge-on-arrival. Executable
    by ``runtime.EventBackend`` only.
    """
    algo = get_algorithm(algorithm)
    if algo.sync_policy.asynchronous:
        return algo
    return Algorithm(name=f"{algo.name}+async",
                     sync_policy=AsyncPeriod(base=algo.sync_policy,
                                             recenter=algo.sync_policy.recenter),
                     local_update=algo.local_update, prox=algo.prox)


def algorithm_names() -> Tuple[str, ...]:
    """Registered algorithm names, in registration order — the exact
    strings ``TrainConfig.algo`` accepts (each also composes with the
    ``"+async"`` suffix for barrier-free execution)."""
    return tuple(_REGISTRY)


register(Algorithm("sync", EveryStep()))
register(Algorithm("lb", EveryStep(), LargeBatchUpdate()))
register(Algorithm("crpsgd", EveryStep(), GrowingBatchUpdate()))
register(Algorithm("local", FixedPeriod()))
register(Algorithm("stl_sc", StagewiseGeometric()))
register(Algorithm("stl_nc1", StagewiseGeometric(recenter=True), prox=True))
register(Algorithm("stl_nc2", StagewiseLinear(recenter=True), prox=True))
# divergence-triggered periods: stl_sc's η_s/T_s schedule, k_s chosen at
# runtime by the replica-divergence probe (cap = the geometric k_s)
register(Algorithm("adaptive", AdaptivePeriod()))
