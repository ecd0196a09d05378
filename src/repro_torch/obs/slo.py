"""Sliding-window SLO monitoring over ``obs.series`` telemetry.

The port of ``src/repro/obs/slo.py``: the same targets, evaluation and
breach intervals over the port's ``obs.series``.

An ``SLOTarget`` names one windowed aggregate of one series (p50/p95/p99
/ mean via ``Series.window_percentile`` / ``window_mean``, or ``rate``
via ``Series.rate`` for cumulative counters) and a threshold; the
``SLOMonitor`` evaluates every target over a ``SeriesRegistry`` and
merges consecutive breaching evaluations into ``SLOBreach`` intervals.

Everything here is a pure function of the recorded samples — evaluated
over virtual-clock serve series the breach intervals are deterministic
per traffic seed, which is why a serving benchmark (the reference's Table 6) can
gate its SLO columns (total breached seconds, time-to-breach) under the same
5% ``bench_diff`` tolerance as the latency percentiles.

The *saturation detector* is the open-loop question the monitor answers:
an SLO that breaches and never recovers before the trace ends means the
offered load exceeded capacity — ``saturated()`` is true iff some
target's last evaluation is still breaching. ``time_to_breach()`` is the
virtual time of the first breach (None below the knee).

Breach intervals export as ``slo_breach`` spans on the virtual clock
(``emit_spans``), so the Perfetto view shows *when* the tail blew up
right above the queue-depth counter track that explains why.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs.series import Series, SeriesRegistry
from repro_torch.obs.trace import CAT_CONTROL, VIRTUAL

__all__ = ["SLOTarget", "SLOBreach", "SLOMonitor", "serve_slo_targets"]

_AGGS = ("mean", "p50", "p95", "p99", "rate")


@dataclass(frozen=True)
class SLOTarget:
    """One service-level objective on one series.

    Breach condition: windowed aggregate ``> threshold`` (or ``<`` with
    ``below=True`` — throughput floors). ``min_count`` delays percentile
    evaluation until the window holds enough samples to mean anything.
    """

    name: str                  # display name, e.g. "ttft_p95"
    series: str                # series name, e.g. "serve.ttft_s"
    agg: str                   # mean | p50 | p95 | p99 | rate
    threshold: float
    window_s: float
    min_count: int = 1
    below: bool = False        # breach when value drops under threshold

    def __post_init__(self):
        if self.agg not in _AGGS:
            raise ValueError(f"SLOTarget {self.name!r}: unknown agg "
                             f"{self.agg!r} (expected one of {_AGGS})")

    def view(self, series: Series) -> Series:
        """The windowed derived series this target evaluates."""
        if self.agg == "rate":
            return series.rate(self.window_s)
        if self.agg == "mean":
            return series.window_mean(self.window_s)
        q = float(self.agg[1:])
        return series.window_percentile(q, self.window_s,
                                        min_count=self.min_count)

    def breached(self, value: float) -> bool:
        return value < self.threshold if self.below \
            else value > self.threshold


@dataclass
class SLOBreach:
    """One maximal run of consecutive breaching evaluations."""

    target: str
    t0: float                  # first breaching evaluation time
    t1: float                  # last consecutive breaching evaluation time
    worst: float               # most-violating aggregate value inside
    n_evals: int = 0           # breaching evaluations merged into this
    open: bool = False         # still breaching at the last evaluation

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclass
class SLOMonitor:
    """Evaluates a set of targets over a SeriesRegistry."""

    targets: Sequence[SLOTarget]
    breaches: List[SLOBreach] = field(default_factory=list)
    # (target name, t, value, breached) — every evaluation, for tests/plots
    evaluations: List[Tuple[str, float, float, bool]] = field(
        default_factory=list)

    def evaluate(self, series: SeriesRegistry) -> List[SLOBreach]:
        """Evaluate every target; returns (and stores) breach intervals.

        A target whose series is absent contributes nothing (the monitor
        composes with partial telemetry); evaluation happens at each
        derived-view sample time, so the cadence is the series' own.
        """
        self.breaches = []
        self.evaluations = []
        for tgt in self.targets:
            src = series.get(tgt.series)
            if src is None or len(src) == 0:
                continue
            cur: Optional[SLOBreach] = None
            for t, v in tgt.view(src).samples():
                bad = tgt.breached(v)
                self.evaluations.append((tgt.name, t, v, bad))
                if bad:
                    if cur is None:
                        cur = SLOBreach(target=tgt.name, t0=t, t1=t,
                                        worst=v, n_evals=1)
                    else:
                        cur.t1 = t
                        cur.n_evals += 1
                        cur.worst = min(cur.worst, v) if tgt.below \
                            else max(cur.worst, v)
                elif cur is not None:
                    self.breaches.append(cur)
                    cur = None
            if cur is not None:
                cur.open = True
                self.breaches.append(cur)
        self.breaches.sort(key=lambda b: (b.t0, b.target))
        return self.breaches

    # -- derived verdicts ----------------------------------------------------

    def time_to_breach(self) -> Optional[float]:
        """Virtual time of the first breaching evaluation (None if every
        target held)."""
        return self.breaches[0].t0 if self.breaches else None

    def breach_seconds(self) -> float:
        """Total breached seconds summed over all intervals (the
        higher-is-worse column the bench gate monitors)."""
        return sum(b.duration_s for b in self.breaches)

    def saturated(self) -> bool:
        """True iff some target was still breaching at its last
        evaluation — the open-loop saturation signal (a transient burst
        breaches and recovers; past-capacity load never recovers)."""
        return any(b.open for b in self.breaches)

    def emit_spans(self, tracer, track: str = "slo"):
        """Lay one ``slo_breach`` span per interval on the virtual clock
        (zero-duration intervals export as instants)."""
        if not tracer:
            return
        for b in self.breaches:
            tracer.add("slo_breach", b.t0, b.t1, cat=CAT_CONTROL,
                       track=track, clock=VIRTUAL,
                       attrs={"target": b.target, "worst": b.worst,
                              "n_evals": b.n_evals, "open": b.open})

    def summary(self) -> dict:
        return {"targets": [t.name for t in self.targets],
                "n_breaches": len(self.breaches),
                "time_to_breach_s": self.time_to_breach(),
                "breach_seconds": self.breach_seconds(),
                "saturated": self.saturated()}


def serve_slo_targets(decode_step_s: float, *,
                      ttft_steps: float = 8.0,
                      e2e_steps: float = 22.0,
                      window_steps: float = 256.0,
                      min_count: int = 4,
                      tok_s_floor: Optional[float] = None,
                      ) -> List[SLOTarget]:
    """Default serve-stack SLOs, thresholds in units of the modeled
    decode step so they scale with the arch/pool instead of hard-coding
    seconds: p95 TTFT ≤ ``ttft_steps`` steps, p99 e2e ≤ ``e2e_steps``
    steps, and optionally a throughput floor (tokens/s over the
    cumulative ``serve.tokens_total`` counter — only meaningful when the
    offered load itself exceeds the floor, so off by default)."""
    w = window_steps * decode_step_s
    targets = [
        SLOTarget("ttft_p95", "serve.ttft_s", "p95",
                  ttft_steps * decode_step_s, w, min_count=min_count),
        SLOTarget("e2e_p99", "serve.e2e_s", "p99",
                  e2e_steps * decode_step_s, w, min_count=min_count),
    ]
    if tok_s_floor is not None:
        targets.append(SLOTarget("tok_s_min", "serve.tokens_total", "rate",
                                 tok_s_floor, w, min_count=1, below=True))
    return targets
