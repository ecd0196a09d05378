"""What the traced run reads from ``torch.profiler``: the kernels of a
short stretch of local steps and a round, the device time under the
program's ranges, the device's busy time, and the breakdown.

The union of kernel intervals (``busy_union_us``) and the device time a
kernel kind or a range takes (``device_ms_by_kind``'s rules: a kernel by
the patterns its name holds, a range by the device time of the kernels
launched inside it) are frozen copies of the readers of the port's
``chip_smoke.py``. A ``record_function`` range shows on the device too,
as a span over its kernels: such annotations are never counted as
kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

ROUND_RANGE = "bench.round"   # the harness's range around each round
# cuBLAS's GEMM kernels, by the names they carry on the H100
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


@dataclass
class Record:
    """The traced stretch, as the per-layer readers see it."""
    model: dict
    traffic: dict
    n_steps: int                      # local steps in the stretch
    wall_s: float                     # the stretch's host-clock length
    kernels: List[Tuple[str, float, float]]   # (name, start µs, end µs)
    range_ms: Dict[str, float]        # device ms under each named range
    round_spans: List[Tuple[float, float]]    # bench.round (µs)
    busy_s: float                     # seconds with any kernel running
    round_ms: List[float] = field(default_factory=list)  # synchronised
    update_leaves: List[Tuple[int, int]] = field(default_factory=list)
    # the traced run's window outside the stretch: local steps, seconds
    # (the profiler slows the steps it records)
    free_steps: int = 0
    free_rounds: int = 0
    free_wall_s: float = 0.0

    def step_kernels(self):
        """The kernels of the local steps: those outside every round."""
        return [k for k in self.kernels
                if not any(a <= k[1] <= b for a, b in self.round_spans)]

    def round_busy_s(self) -> float:
        """Seconds with a kernel of a round running."""
        return busy_union_us([(a, b) for _, a, b in self.kernels
                              if any(x <= a <= y
                                     for x, y in self.round_spans)]) / 1e6

    def kernel_ms(self, patterns, kernels=None) -> Tuple[int, float]:
        """(launches, device ms) of the kernels whose names hold one of
        ``patterns``."""
        hits = [k for k in (self.kernels if kernels is None else kernels)
                if any(p in k[0] for p in patterns)]
        return len(hits), sum(b - a for _, a, b in hits) / 1e3


def busy_union_us(spans) -> float:
    """µs in which at least one kernel ran: the union of the intervals
    (kernels that overlap count once)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read(prof, ranges, n_steps: int, wall_s: float, model: dict,
         traffic: dict) -> Tuple[Record, dict]:
    """The stretch's ``Record`` and the run's ``breakdown`` from a stopped
    profiler; ``ranges``: the program's range names to read.

    Read from the profiler's raw events: a kernel is charged to a range
    when the host op that launched it (its linked correlation) started
    inside one of the range's spans, as ``key_averages`` charges a range
    with its children's kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, launched, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                kernels.append((e.name(), a, b))
                launched.append(e.linked_correlation_id())
        else:
            host.append((e.name(), a, b, e.correlation_id()))
    op_start = {c: a for _, a, _, c in host}
    t = np.array([op_start.get(c, np.nan) for c in launched])
    dur_ms = np.array([b - a for _, a, b in kernels]) / 1e3
    range_ms = {}
    for name in ranges:
        spans = sorted((a, b) for n, a, b, _ in host if n == name)
        if not spans or not kernels:
            range_ms[name] = 0.0
            continue
        lo = np.array([sp[0] for sp in spans])
        hi = np.array([sp[1] for sp in spans])
        i = np.searchsorted(lo, t, side="right") - 1
        inside = (i >= 0) & (t <= hi[np.clip(i, 0, None)])
        range_ms[name] = float(dur_ms[inside].sum())
    rounds = [(a, b) for n, a, b, _ in host if n == ROUND_RANGE]
    busy = busy_union_us([(a, b) for _, a, b in kernels])
    rec = Record(model, traffic, n_steps, wall_s, kernels, range_ms, rounds,
                 busy / 1e6)
    return rec, breakdown(host, kernels)


def breakdown(host, kernels, top: int = 10, gaps: int = 200) -> dict:
    """The device operations that took most time (summed by name), and
    the longest idle gaps of the device summed by what the host was doing
    then: the innermost host op open at the gap's middle."""
    by_name: Dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((a, b) for _, a, b in kernels)
    idle = []
    end = None
    for a, b in spans:
        if end is not None and a > end:
            idle.append((a - end, end, a))
        end = b if end is None else max(end, b)
    idle = sorted(idle, reverse=True)[:gaps]
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    names = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for dur, a, b in idle:
        mid = (a + b) / 2
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if open_.size:
            i = open_[np.argmin(ends[open_] - starts[open_])]
            name = names[i]
        else:
            name = "host outside any op"
        by_host[name] = by_host.get(name, 0.0) + dur / 1e6
    gaps_out = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps_out]}
