# Discrete-event heterogeneous-client runtime: a virtual clock + per-client
# processes (sampled compute rates, α–β network draws, dropout) behind an
# EventBackend that plugs into engine.Engine.run like the simulator —
# synchronous policies replay barrier rounds on the clock (the simulator's
# numerics), AsyncPeriod policies merge uploads on arrival through
# comm.StalenessWeightedMean. Upload schedules decide how round-end
# messages meet the clock: BlockingSchedule (one monolithic message) or
# StreamingSchedule (per-leaf uploads overlapping the final local step).
# The serving engine runs on the same clock.
from repro_torch.runtime.client import (ClientProcess, Heterogeneity,
                                        sample_clients)
from repro_torch.runtime.clock import Clock, Event, EventQueue
from repro_torch.runtime.runtime import (
    EventBackend,
    RuntimeResult,
    run,
    staleness_reducer_for,
)
from repro_torch.runtime.schedule import (
    BlockingSchedule,
    StreamingSchedule,
    UploadSchedule,
    get_schedule,
)

__all__ = [
    "BlockingSchedule",
    "ClientProcess",
    "Clock",
    "Event",
    "EventBackend",
    "EventQueue",
    "Heterogeneity",
    "RuntimeResult",
    "StreamingSchedule",
    "UploadSchedule",
    "get_schedule",
    "run",
    "sample_clients",
    "staleness_reducer_for",
]
