"""Virtual clock + deterministic event queue for the discrete-event runtime.

The port's copy of ``src/repro/runtime/clock.py``: the event runtime
(``runtime.EventBackend``) and the serving engine schedule on it.

The runtime's time is *modeled*, not measured: every client process and
network transfer schedules events on one global ``EventQueue``; the
``Clock`` advances monotonically to each popped event's timestamp. Events
with identical timestamps pop in insertion order (a monotonically
increasing sequence number breaks ties), so a run's event trace is a pure
function of its configuration and seeds — the property the dropout
determinism tests pin.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


@dataclass(order=True, frozen=True)
class Event:
    """One scheduled occurrence. Ordering: (time, seq) — kind/client/info
    never participate in comparisons, so heap order is deterministic."""

    time: float                             # modeled seconds
    seq: int                                # insertion order (tie-break)
    # "compute_done" | "arrival" | "leaf_arrival" (streaming uploads,
    # info=(leaf index,)) | "merge" | "dropout" | "drop" | ...
    kind: str = field(compare=False)
    client: int = field(compare=False, default=-1)
    info: tuple = field(compare=False, default=())


class EventQueue:
    """Min-heap of Events with deterministic FIFO tie-breaking."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client: int = -1,
             info: tuple = ()) -> Event:
        """Schedule an event at ``time`` modeled seconds; same-time events
        pop in push order (the monotone ``seq`` breaks ties)."""
        ev = Event(time=float(time), seq=self._seq, kind=kind, client=client,
                   info=info)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        """Remove and return the earliest scheduled event."""
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        """The earliest scheduled event without removing it (None if
        empty)."""
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class Clock:
    """Monotone virtual time in modeled seconds."""

    def __init__(self):
        self.now = 0.0

    def advance(self, t: float) -> float:
        """Move to (at least) time t; time never flows backwards."""
        self.now = max(self.now, float(t))
        return self.now


# (time_s, kind, client[, leaf index]) — streaming "leaf_arrival" entries
# carry the leaf index as a fourth element
TraceEntry = Union[Tuple[float, str, int], Tuple[float, str, int, int]]
