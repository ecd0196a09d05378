"""Admission control + slot allocation for the continuous-batching engine.

The engine owns a fixed pool of KV-cache slots (the decode batch is always
``n_slots`` wide; empty slots decode garbage that is never read). The
scheduler decides, at every decode-step boundary, which waiting requests
join free slots:

  * **bounded queue** — at most ``max_queue`` requests wait; arrivals past
    that are rejected (counted, never silently dropped);
  * **length guard** — a request whose prompt + generation (+ frontend
    tokens) cannot fit ``max_seq_len`` is rejected at enqueue time, not
    wedged forever at the head of the FCFS queue;
  * **token budget** — total cache-token footprint of in-flight requests
    is capped (defaults to ``n_slots × max_seq_len``, i.e. slot-bound);
  * **prefill/decode interleaving** — at most ``max_prefills_per_step``
    admissions per step boundary, so a deep queue cannot starve in-flight
    decodes (each admission costs one serialized prefill on the modeled
    clock).

Everything is deterministic: FCFS admission order, lowest-index-first slot
allocation, no wall-clock anywhere — two runs over the same traffic make
identical decisions, which the determinism tests pin.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.serve.traffic import Request


class SlotPool:
    """Fixed pool of decode slots; lowest free index allocates first."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """Claim the lowest free slot index (raises when full)."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        return heapq.heappop(self._free)

    def free(self, slot: int):
        """Return a slot to the pool."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range 0..{self.n_slots-1}")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        heapq.heappush(self._free, slot)


@dataclass(frozen=True)
class SchedulerConfig:
    """Admission-control knobs (see module docstring for semantics)."""

    n_slots: int = 8
    max_seq_len: int = 256           # per-slot KV-cache length (token slots)
    max_queue: int = 64              # bounded waiting room
    token_budget: Optional[int] = None   # in-flight cache tokens; None =
    #                                      n_slots × max_seq_len (slot-bound)
    max_prefills_per_step: int = 1   # admissions per decode-step boundary

    def resolved_budget(self) -> int:
        return (self.token_budget if self.token_budget is not None
                else self.n_slots * self.max_seq_len)


@dataclass
class Admission:
    """One admission decision: request → slot, at a step boundary."""

    request: Request
    slot: int


class Scheduler:
    """FCFS admission control over a bounded queue + the slot pool.

    Lifecycle per request: ``offer`` at arrival (may reject: queue full /
    too long), then ``admit`` at a step boundary moves the queue head into
    free slots subject to the token budget and the per-step prefill cap,
    then ``release`` at retirement frees the slot and its budget share.
    """

    def __init__(self, cfg: SchedulerConfig, n_frontend_tokens: int = 0):
        if cfg.max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1 "
                             f"(got {cfg.max_prefills_per_step})")
        self.cfg = cfg
        self.pool = SlotPool(cfg.n_slots)
        self.n_frontend_tokens = n_frontend_tokens
        self.queue: List[Request] = []       # FCFS waiting room
        self.in_flight: Dict[int, Request] = {}   # slot -> request
        self._budget_used = 0
        self.rejected_full: List[Request] = []
        self.rejected_too_long: List[Request] = []

    # -- accounting ---------------------------------------------------------

    def _footprint(self, req: Request) -> int:
        """Cache-token footprint: prompt + generated + frontend tokens."""
        fe = self.n_frontend_tokens if req.frontend is not None else 0
        return req.total_tokens + fe

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def occupancy(self) -> int:
        return len(self.in_flight)

    # -- lifecycle ----------------------------------------------------------

    def offer(self, req: Request) -> bool:
        """A request arrives. Returns False when rejected (and records
        which bound rejected it)."""
        # the budget bound matters too: a request no in-flight set can ever
        # satisfy would wedge the FCFS head forever
        if self._footprint(req) > min(self.cfg.max_seq_len,
                                      self.cfg.resolved_budget()):
            self.rejected_too_long.append(req)
            return False
        if len(self.queue) >= self.cfg.max_queue:
            self.rejected_full.append(req)
            return False
        self.queue.append(req)
        return True

    def admit(self) -> List[Admission]:
        """Move FCFS queue heads into free slots at a step boundary.

        Stops at the first request that doesn't fit the token budget
        (strict FCFS — no smaller request overtakes, so admission order is
        arrival order and the latency ledger stays honest), at slot
        exhaustion, or at the per-step prefill cap.
        """
        out: List[Admission] = []
        budget = self.cfg.resolved_budget()
        while (self.queue and self.pool.n_free > 0
               and len(out) < self.cfg.max_prefills_per_step):
            req = self.queue[0]
            fp = self._footprint(req)
            if self._budget_used + fp > budget:
                break
            self.queue.pop(0)
            slot = self.pool.alloc()
            self.in_flight[slot] = req
            self._budget_used += fp
            out.append(Admission(request=req, slot=slot))
        return out

    def release(self, slot: int) -> Request:
        """Retire the request occupying ``slot``; frees slot + budget."""
        req = self.in_flight.pop(slot)
        self._budget_used -= self._footprint(req)
        self.pool.free(slot)
        return req

    @property
    def idle(self) -> bool:
        """Nothing queued, nothing in flight."""
        return not self.queue and not self.in_flight
