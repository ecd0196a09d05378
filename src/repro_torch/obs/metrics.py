"""Process-local metrics registry — the aggregate half of ``repro_torch.obs``.

Counters (monotone sums), gauges (last-write-wins) and histograms
(count/sum/min/max summaries), each keyed by a metric name plus optional
labels. All three execution backends, the engine ledger and the
``comm.Reducer`` implementations report into one process-local default
registry; ``Engine.run`` snapshots it into ``EngineReport.metrics`` when
a run finishes.

Metric names use dotted namespaces (``engine.rounds``,
``comm.bytes``, ``runtime.merge_staleness``); units ride on the metric
object and in the snapshot so reports stay self-describing — see the
metric table in docs/observability.md.

This is deliberately not a Prometheus client: no locks (JAX host code is
single-threaded per process), no export protocol — ``snapshot()`` returns
plain dicts that serialize into BENCH/report artifacts.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key) if key else ""


@dataclass
class Metric:
    """Base: one named family of labelled series."""

    name: str
    unit: str = ""
    help: str = ""
    kind: str = "metric"
    values: Dict[LabelKey, float] = field(default_factory=dict)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "values": {_label_str(k): v for k, v in
                           sorted(self.values.items())}}


@dataclass
class Counter(Metric):
    """Monotone sum (events, bytes, rounds)."""

    kind: str = "counter"

    def inc(self, value: float = 1.0, **labels):
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)


@dataclass
class Gauge(Metric):
    """Last-write-wins sample (per-stage objective, queue depth)."""

    kind: str = "gauge"

    def set(self, value: float, **labels):
        self.values[_label_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        return self.values.get(_label_key(labels))


PERCENTILES = (50.0, 95.0, 99.0)   # the tail summary every histogram carries


def _percentile(xs: List[float], q: float) -> float:
    """q-th percentile of ``xs`` with linear interpolation between closest
    ranks — numerically identical to ``numpy.percentile(xs, q)`` (the
    default "linear" method), which the unit tests pin."""
    ys = sorted(xs)
    if len(ys) == 1:
        return ys[0]
    rank = (q / 100.0) * (len(ys) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(ys):
        return ys[-1]
    return ys[lo] + frac * (ys[lo + 1] - ys[lo])


@dataclass
class Histogram(Metric):
    """count/sum/min/max + p50/p95/p99 summary per label set (staleness,
    round times, request latencies).

    Raw samples are retained per label set *up to* ``cap`` (default
    4096): below it percentiles are exact (numpy-identical linear
    interpolation); past it the retained set becomes a uniform reservoir
    (Algorithm R, deterministically seeded per (metric, label set)) so
    memory stays O(cap) at cohort scale while percentiles degrade to an
    unbiased approximation — ``summary()`` flags this with
    ``approx: True``, never silently. count/sum/min/max stay exact at
    any volume. Bounded consumers that need exact tails (the serve
    latency ledger's p50/p95/p99 columns) pin a cap above their sample
    counts.
    """

    kind: str = "histogram"
    cap: int = 4096
    stats: Dict[LabelKey, dict] = field(default_factory=dict)
    samples: Dict[LabelKey, List[float]] = field(default_factory=dict)
    _rngs: Dict[LabelKey, random.Random] = field(default_factory=dict,
                                                 repr=False)

    def _rng(self, k: LabelKey) -> random.Random:
        rng = self._rngs.get(k)
        if rng is None:
            seed = zlib.crc32(f"{self.name}|{_label_str(k)}".encode())
            rng = self._rngs[k] = random.Random(seed)
        return rng

    def observe(self, value: float, **labels):
        v = float(value)
        k = _label_key(labels)
        st = self.stats.setdefault(k, {"count": 0, "sum": 0.0,
                                       "min": v, "max": v})
        st["count"] += 1
        st["sum"] += v
        st["min"] = min(st["min"], v)
        st["max"] = max(st["max"], v)
        xs = self.samples.setdefault(k, [])
        if len(xs) < self.cap:
            xs.append(v)
        else:
            # reservoir sampling (Algorithm R): keep each of the count
            # observations with equal probability cap/count
            j = self._rng(k).randrange(st["count"])
            if j < self.cap:
                xs[j] = v

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Exact q-th percentile of everything observed under ``labels``
        (None when nothing was observed)."""
        xs = self.samples.get(_label_key(labels))
        return _percentile(xs, q) if xs else None

    def _full(self, k: LabelKey) -> dict:
        st = self.stats[k]
        out = dict(st)
        out["mean"] = st["sum"] / st["count"] if st["count"] else 0.0
        xs = self.samples.get(k)
        for q in PERCENTILES:
            out[f"p{q:g}"] = _percentile(xs, q) if xs else None
        # approx: percentiles come from a reservoir, not the full set
        out["approx"] = bool(xs is not None and st["count"] > len(xs))
        return out

    def summary(self, **labels) -> Optional[dict]:
        k = _label_key(labels)
        if k not in self.stats:
            return None
        return self._full(k)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "values": {_label_str(k): self._full(k)
                           for k, v in sorted(self.stats.items())}}


class MetricsRegistry:
    """Name → Metric map with idempotent, kind-checked registration."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, unit: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, unit=unit, help=help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.__name__.lower()}")
        return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "", help: str = "",
                  cap: Optional[int] = None) -> Histogram:
        """``cap`` bounds retained raw samples (reservoir past it); only
        honored at first registration — registration stays idempotent."""
        kw = {} if cap is None else {"cap": cap}
        return self._get(Histogram, name, unit, help, **kw)

    def snapshot(self) -> dict:
        """Serializable view of every registered series, sorted by name."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def reset(self):
        """Drop all series (tests / run isolation)."""
        self._metrics.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-local default registry everything reports into."""
    return _DEFAULT


def reset():
    """Reset the default registry (run/test isolation)."""
    _DEFAULT.reset()
