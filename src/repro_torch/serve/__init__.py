"""repro_torch.serve — continuous-batching inference on the card.

The port of ``repro.serve``: open-loop synthetic traffic on the virtual
clock, FCFS admission control over a fixed KV-cache slot pool, and one
batched decode step over every slot per step boundary. Layers:

  * ``traffic``   — Poisson / bursty (MMPP) arrivals, sampled prompt and
    output lengths; a pure function of the seed, identical to the JAX
    package's request lists (both draw from numpy's ``RandomState``).
  * ``scheduler`` — bounded-queue FCFS admission control, token budget,
    prefill/decode interleaving cap, lowest-index slot allocation.
  * ``engine``    — ``ServeEngine``: prefill through the flash-attention
    kernel into a slot's rows of the stacked cache, in place; one decode
    step for all slots. Checkpoint restore (``from_checkpoint``) and
    ``profile=`` wait for their slices (ROADMAP queue 1).
  * ``ledger``    — per-request latency records (queue wait, TTFT, TPOT,
    e2e) surfaced as spans and ``serve.*`` metrics.
"""
from repro_torch.serve.engine import DeviceModel, ServeEngine, ServeReport
from repro_torch.serve.ledger import RequestRecord, emit_spans, publish_metrics
from repro_torch.serve.scheduler import (
    Admission,
    Scheduler,
    SchedulerConfig,
    SlotPool,
)
from repro_torch.serve.traffic import (
    Request,
    TrafficConfig,
    arrival_summary,
    generate_requests,
    offered_load,
)

__all__ = [
    "DeviceModel", "ServeEngine", "ServeReport",
    "RequestRecord", "emit_spans", "publish_metrics",
    "Admission", "Scheduler", "SchedulerConfig", "SlotPool",
    "Request", "TrafficConfig", "arrival_summary", "generate_requests",
    "offered_load",
]
