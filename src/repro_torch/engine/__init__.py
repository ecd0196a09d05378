# Algorithm / SyncPolicy / Topology API. An Algorithm bundles a SyncPolicy
# (when to communicate: the stagewise η_s/T_s/k_s schedules and prox-center
# policy) with a LocalUpdate (how clients step); a Topology routes the
# round's bytes with per-hop α–β pricing; the Engine drives any registered
# algorithm through a backend over one shared stage stream.
from repro_torch.engine.algorithm import (
    Algorithm,
    algorithm_names,
    get_algorithm,
    make_async,
    register,
)
from repro_torch.engine.engine import (Engine, EngineReport, StageStatus,
                                       topology_for)
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
from repro_torch.engine.topology import (
    Hierarchical,
    HopCost,
    LeafCost,
    Star,
    StreamingStar,
    Topology,
    get_topology,
)
from repro_torch.engine.update import (
    GrowingBatchUpdate,
    LargeBatchUpdate,
    LocalUpdate,
    SgdUpdate,
)

__all__ = [
    "AdaptivePeriod",
    "Algorithm",
    "AsyncPeriod",
    "Engine",
    "EngineReport",
    "EveryStep",
    "FixedPeriod",
    "GrowingBatchUpdate",
    "Hierarchical",
    "HopCost",
    "LargeBatchUpdate",
    "LeafCost",
    "LocalUpdate",
    "SgdUpdate",
    "Stage",
    "StageStatus",
    "StagewiseGeometric",
    "StagewiseLinear",
    "Star",
    "StreamingStar",
    "SyncPolicy",
    "Topology",
    "algorithm_names",
    "get_algorithm",
    "get_topology",
    "make_async",
    "register",
    "topology_for",
]
