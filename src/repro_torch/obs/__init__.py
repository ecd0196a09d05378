"""repro_torch.obs — observability for the port's engine stack.

The port of ``src/repro/obs``, the same API:

  * ``obs.trace`` — nested spans on three clock domains: measured wall
    time, the event runtime's virtual clock, and the engine ledger's
    modeled α–β timeline. Zero overhead when disabled (``NULL_TRACER`` is
    falsy).
  * ``obs.metrics`` — process-local counters/gauges/histograms.
  * ``obs.series`` — ``(t, value)`` time series on the same three clocks
    with windowed derived views and a strict clock-domain guard.
  * ``obs.slo`` — sliding-window SLO monitoring over serve series,
    breach spans on the virtual clock, the open-loop saturation detector.
  * ``obs.profile`` — a ``torch.profiler`` session wrapper and
    synchronised wall timing of steps; the modeled-vs-measured skew table
    behind ``launch/{train,serve}.py --profile``.
  * ``obs.export`` — JSONL span logs (round-tripping via ``read_jsonl``)
    and Chrome-trace/Perfetto JSON.
  * ``obs.diff`` — schema-validated BENCH_*.json loading and numeric
    regression diffing (``tools/torch_bench_diff.py``).
"""
from repro_torch.obs.diff import (
    BenchSchemaError,
    Delta,
    DIFF_KEYS,
    DirDiff,
    diff_benches,
    diff_dirs,
    load_bench,
    row_key,
    validate_bench,
)
from repro_torch.obs.export import (
    read_jsonl,
    span_record,
    to_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    reset,
)
from repro_torch.obs.profile import ProfileSession, StepTiming, format_skew_table
from repro_torch.obs.series import ClockDomainError, Series, SeriesRegistry
from repro_torch.obs.slo import SLOBreach, SLOMonitor, SLOTarget, serve_slo_targets
from repro_torch.obs.trace import (
    CAT_COMM,
    CAT_COMPUTE,
    CAT_CONTROL,
    CAT_MERGE,
    MODELED,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    VIRTUAL,
    WALL,
)

__all__ = [
    "BenchSchemaError", "Delta", "DIFF_KEYS", "DirDiff", "diff_benches",
    "diff_dirs", "load_bench", "row_key", "validate_bench",
    "read_jsonl", "span_record", "to_chrome_trace", "write_chrome_trace",
    "write_jsonl",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry", "reset",
    "ProfileSession", "StepTiming", "format_skew_table",
    "ClockDomainError", "Series", "SeriesRegistry",
    "SLOBreach", "SLOMonitor", "SLOTarget", "serve_slo_targets",
    "CAT_COMM", "CAT_COMPUTE", "CAT_CONTROL", "CAT_MERGE", "MODELED",
    "NULL_TRACER", "NullTracer", "Span", "Tracer", "VIRTUAL", "WALL",
]
