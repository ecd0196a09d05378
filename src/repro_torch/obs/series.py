"""Time-series telemetry — the trajectory half of ``repro_torch.obs``.

``obs.metrics`` answers "what were the totals"; this module answers "what
was the *curve*": a ``Series`` records ``(t, value)`` samples on exactly
one of the three clock domains (``virtual`` / ``modeled`` / ``wall``,
see ``obs.trace``), and a ``SeriesRegistry`` keys series by name with a
strict clock-domain guard — re-registering a name on a different clock
raises ``ClockDomainError`` instead of silently mixing timelines (a
virtual-clock queue-depth sample interleaved into a modeled-clock byte
curve would be meaningless and *look* plausible).

Emitters across the stack:

  * ``engine.Engine`` — per-round ``comm.round_bytes`` /
    ``comm.round_time_s`` / ``comm.cum_bytes`` and per-stage
    ``train.stage_objective`` vs ``train.stage_bytes`` on the modeled
    clock (the stagewise objective-vs-communication curve the paper is
    about);
  * ``runtime.EventBackend`` — ``runtime.active_clients``,
    ``runtime.inflight_merges``, ``runtime.merge_staleness``,
    ``runtime.round_time_s`` on the virtual clock;
  * ``serve.ServeEngine`` — ``serve.queue_depth``,
    ``serve.batch_occupancy``, ``serve.tokens_total`` (+ the derived
    ``serve.tokens_s`` rate) and the per-request ``serve.ttft_s`` /
    ``serve.e2e_s`` sample series on the virtual clock.

Derived views are *windowed*: ``rate`` (windowed average rate of a
cumulative counter), ``window_mean`` and ``window_percentile`` (sliding
p50/p95/p99 using the same linear interpolation as ``obs.metrics``, so
windowed and global percentiles never disagree on the same samples).
Each view returns a new ``Series`` on the same clock, so views compose
and export as counter tracks like any recorded series
(``obs.export.to_chrome_trace(..., series=...)``).

Determinism: series on the virtual/modeled clocks are a pure function of
(config, seed) — ``SeriesRegistry.fingerprint()`` is what the same-seed
tests compare. Samples recorded out of time order (e.g. request finish
times in id order) are sorted lazily and stably on read.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.obs.metrics import _percentile
from repro_torch.obs.trace import CLOCKS

__all__ = ["ClockDomainError", "Series", "SeriesRegistry", "registry",
           "reset"]


class ClockDomainError(ValueError):
    """A series was requested on a different clock than it was registered
    on (or on a clock that does not exist)."""


class Series:
    """One named ``(t, value)`` sample stream on a single clock domain.

    ``max_samples`` bounds memory for open-ended emitters: past the cap
    further samples are *dropped* (counted in ``dropped``, surfaced in
    ``snapshot()``) — deterministic keep-first semantics, never silent.
    """

    __slots__ = ("name", "clock", "unit", "help", "max_samples", "dropped",
                 "_t", "_v", "_sorted")

    def __init__(self, name: str, clock: str, unit: str = "",
                 help: str = "", max_samples: Optional[int] = None):
        if clock not in CLOCKS:
            raise ClockDomainError(
                f"series {name!r}: unknown clock {clock!r} "
                f"(expected one of {CLOCKS})")
        self.name = name
        self.clock = clock
        self.unit = unit
        self.help = help
        self.max_samples = max_samples
        self.dropped = 0
        self._t: List[float] = []
        self._v: List[float] = []
        self._sorted = True

    def record(self, t: float, value: float):
        """Append one sample at time ``t`` (seconds on this clock)."""
        if self.max_samples is not None and len(self._t) >= self.max_samples:
            self.dropped += 1
            return
        t = float(t)
        if self._t and t < self._t[-1]:
            self._sorted = False
        self._t.append(t)
        self._v.append(float(value))

    # -- reads ---------------------------------------------------------------

    def _ensure_sorted(self):
        if not self._sorted:
            order = sorted(range(len(self._t)), key=lambda i: self._t[i])
            self._t = [self._t[i] for i in order]
            self._v = [self._v[i] for i in order]
            self._sorted = True

    def __len__(self) -> int:
        return len(self._t)

    def __bool__(self) -> bool:
        return True

    def samples(self) -> List[Tuple[float, float]]:
        """All samples, sorted by time (stable for ties)."""
        self._ensure_sorted()
        return list(zip(self._t, self._v))

    def times(self) -> List[float]:
        self._ensure_sorted()
        return list(self._t)

    def values(self) -> List[float]:
        self._ensure_sorted()
        return list(self._v)

    def last(self) -> Optional[Tuple[float, float]]:
        self._ensure_sorted()
        return (self._t[-1], self._v[-1]) if self._t else None

    def summary(self) -> dict:
        """Whole-series aggregate (count / min / max / mean / last)."""
        vs = self.values()
        out = {"count": len(vs), "dropped": self.dropped}
        if vs:
            out.update(min=min(vs), max=max(vs),
                       mean=sum(vs) / len(vs), last=vs[-1])
        return out

    # -- windowed derived views ---------------------------------------------

    def _windows(self, window_s: float) -> Iterator[Tuple[int, int]]:
        """(lo, i) index pairs: for each sample i, lo is the first index
        with ``t > t_i - window_s`` (two-pointer, O(n))."""
        self._ensure_sorted()
        lo = 0
        for i, t in enumerate(self._t):
            while self._t[lo] <= t - window_s:
                lo += 1
            yield lo, i

    def _derived(self, name: Optional[str], suffix: str, unit: str) -> "Series":
        return Series(name or f"{self.name}.{suffix}", self.clock,
                      unit=unit, help=f"{suffix} view of {self.name}")

    def rate(self, window_s: float, name: Optional[str] = None) -> "Series":
        """Windowed average rate of a cumulative counter: at each sample
        ``t_i``, ``(v_i − v_j) / (t_i − t_j)`` where ``j`` is the last
        sample at or before ``t_i − window_s`` (the first sample when the
        window reaches past the start). Zero-span windows yield no sample.
        """
        out = self._derived(name, "rate", f"{self.unit}/s" if self.unit
                            else "1/s")
        self._ensure_sorted()
        for i, t in enumerate(self._t):
            j = i
            while j > 0 and self._t[j - 1] > t - window_s:
                j -= 1
            j = max(0, j - 1) if j > 0 else 0
            dt = t - self._t[j]
            if dt > 0.0:
                out.record(t, (self._v[i] - self._v[j]) / dt)
        return out

    def window_mean(self, window_s: float,
                    name: Optional[str] = None) -> "Series":
        """Sliding-window mean: at each sample time, the mean of every
        sample inside ``(t − window_s, t]``."""
        out = self._derived(name, "mean", self.unit)
        acc = 0.0
        prev_lo = 0
        for lo, i in self._windows(window_s):
            acc += self._v[i]
            while prev_lo < lo:
                acc -= self._v[prev_lo]
                prev_lo += 1
            out.record(self._t[i], acc / (i - lo + 1))
        return out

    def window_percentile(self, q: float, window_s: float,
                          name: Optional[str] = None,
                          min_count: int = 1) -> "Series":
        """Sliding-window q-th percentile over ``(t − window_s, t]`` —
        same linear interpolation as ``obs.metrics`` histograms (numpy's
        default method), emitted only once the window holds at least
        ``min_count`` samples."""
        out = self._derived(name, f"p{q:g}", self.unit)
        for lo, i in self._windows(window_s):
            xs = self._v[lo:i + 1]
            if len(xs) >= min_count:
                out.record(self._t[i], _percentile(xs, q))
        return out

    # -- identity / serialization -------------------------------------------

    def fingerprint(self) -> tuple:
        """Deterministic identity (same-seed ⇒ identical fingerprints on
        the virtual/modeled clocks — what the determinism tests compare)."""
        return (self.name, self.clock, self.unit,
                tuple(self.samples()), self.dropped)

    def snapshot(self) -> dict:
        return {"clock": self.clock, "unit": self.unit, "help": self.help,
                "summary": self.summary()}


class SeriesRegistry:
    """Name → ``Series`` map with idempotent, clock-guarded registration.

    Mirrors ``MetricsRegistry``: asking for an existing name returns the
    existing series — but only on the clock it was registered on; a
    mismatch raises ``ClockDomainError`` (never silently re-clocks).
    """

    def __init__(self):
        self._series: Dict[str, Series] = {}

    def series(self, name: str, clock: str, unit: str = "", help: str = "",
               max_samples: Optional[int] = None) -> Series:
        s = self._series.get(name)
        if s is None:
            s = Series(name, clock, unit=unit, help=help,
                       max_samples=max_samples)
            self._series[name] = s
        elif s.clock != clock:
            raise ClockDomainError(
                f"series {name!r} already registered on clock "
                f"{s.clock!r}, requested {clock!r}")
        return s

    def add(self, series: Series) -> Series:
        """Insert an externally built series (e.g. a derived view). The
        same clock guard applies against any existing name."""
        cur = self._series.get(series.name)
        if cur is not None and cur.clock != series.clock:
            raise ClockDomainError(
                f"series {series.name!r} already registered on clock "
                f"{cur.clock!r}, adding {series.clock!r}")
        self._series[series.name] = series
        return series

    def get(self, name: str) -> Optional[Series]:
        return self._series.get(name)

    def names(self) -> List[str]:
        return sorted(self._series)

    def __contains__(self, name: str) -> bool:
        return name in self._series

    def __getitem__(self, name: str) -> Series:
        return self._series[name]

    def __iter__(self) -> Iterator[Series]:
        return iter([self._series[n] for n in self.names()])

    def __len__(self) -> int:
        return len(self._series)

    def fingerprint(self) -> dict:
        return {n: self._series[n].fingerprint() for n in self.names()}

    def snapshot(self) -> dict:
        """Serializable view (summaries only — samples stay in memory;
        export them as Perfetto counter tracks via ``obs.export``)."""
        return {n: self._series[n].snapshot() for n in self.names()}

    def reset(self):
        self._series.clear()


_DEFAULT = SeriesRegistry()


def registry() -> SeriesRegistry:
    """The process-local default series registry (mirrors
    ``obs.metrics.registry()``)."""
    return _DEFAULT


def reset():
    """Reset the default registry (run/test isolation)."""
    _DEFAULT.reset()
