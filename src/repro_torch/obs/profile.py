"""Measured-time profiling — closing the loop on the modeled clocks.

The port of ``src/repro/obs/profile.py``. Everything else in
``repro_torch.obs`` prices runs on *modeled* clocks (the α–β ledger, the
roofline serve steps). This module measures the same steps on the host and
reports the skew:

  * ``ProfileSession`` — a context manager that (optionally) wraps the
    run in a ``torch.profiler`` session (``logdir=`` writes its Chrome
    trace, the torch counterpart of the reference's XPlane artifact; a
    profiler that cannot start degrades to wall timing with a warning,
    never a crash) and records per-call wall timings, synchronised with
    the card, next to their modeled prices;
  * ``skew_table()`` — per-step-name rows ``{name, calls, modeled_s,
    measured_s, skew}`` where ``skew = measured / modeled`` (>1: the
    model is optimistic; <1: the host beat the roofline — e.g. smoke
    shapes fitting in cache);
  * ``emit_spans()`` — one ``profile.<name>`` span per measured call on
    the **wall** clock carrying both ``modeled_s`` and ``measured_s``
    attrs. Wall spans are excluded from the determinism fingerprints by
    construction (``Span.key()``), so measured time still never leaks
    into the modeled/virtual ledgers.

Surfaced by ``launch/train.py --profile`` (train/sync steps against the
DeviceModel roofline and the topology's α–β round price) and
``launch/serve.py --profile`` (prefill/decode steps against the serve
roofline).
"""
from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.obs.trace import CAT_COMPUTE, WALL
from repro_torch.utils.logging import RUN_ID, get_logger
from repro_torch.utils.tree import tree_leaves

log = get_logger("obs.profile")

__all__ = ["ProfileSession", "StepTiming", "format_skew_table"]


def _block_until_ready(x):
    """Wait for the card when ``x`` holds a CUDA tensor (each card it
    names); host values pass through without a wait. The counterpart of
    ``jax.block_until_ready``: PyTorch returns before the card is done."""
    devices = {t.device for t in tree_leaves(x)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


@dataclass
class StepTiming:
    """One measured call of one profiled step."""

    name: str
    modeled_s: float           # the clock-domain price of this call
    measured_s: float          # host seconds, synchronised with the card
    t0: float                  # time.monotonic() at call start
    t1: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def skew(self) -> float:
        return (self.measured_s / self.modeled_s if self.modeled_s > 0
                else float("inf"))


class ProfileSession:
    """Collects modeled-vs-measured step timings for one run.

    Use as a context manager; with ``logdir`` set the session brackets
    the run in a ``torch.profiler.profile`` session (host ops, and the
    card's kernels where there is a card) and writes its Chrome trace to
    ``trace_path`` under ``logdir`` on exit (Perfetto- and
    TensorBoard-loadable); ``profiler`` keeps the session for
    ``key_averages()``. ``trace_calls`` narrows the profiler to that many
    measured calls, from the second (the first is a warm-up: one-time
    allocations and library handles): a full-width model runs tens of
    thousands of kernels a step, and a whole run's trace would take
    gigabytes. Such calls carry ``attrs["traced"]``. The wall-timing
    harness works regardless: ``step`` / ``wrap`` time each call up to a
    synchronisation with the card, so asynchronous launches can't hide
    device time.
    """

    def __init__(self, logdir: Optional[str] = None,
                 trace_calls: Optional[int] = None):
        if trace_calls is not None and trace_calls < 1:
            raise ValueError(f"trace_calls must be >= 1, got {trace_calls}")
        self.logdir = logdir
        self.trace_calls = trace_calls
        self.records: List[StepTiming] = []
        self.profiler = None
        self.trace_path: Optional[str] = None
        self._tracing = False

    # -- torch.profiler session ---------------------------------------------

    def __enter__(self) -> "ProfileSession":
        if self.logdir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            self.profiler = torch.profiler.profile(activities=acts)
            if self.trace_calls is None:
                self._start()
        return self

    def __exit__(self, *exc):
        self._stop()
        return False

    def _start(self):
        try:
            self.profiler.start()
            self._tracing = True
        except Exception as e:  # a build without profiling support
            log.warning("profiler_unavailable", error=str(e),
                        logdir=self.logdir)
            self.profiler = None

    def _stop(self):
        if not self._tracing:
            return
        self._tracing = False
        try:
            self.profiler.stop()
            path = os.path.join(self.logdir,
                                f"torch_profile_{RUN_ID}.pt.trace.json")
            self.profiler.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:
            log.warning("profiler_stop_failed", error=str(e))

    # -- the wall-timing harness --------------------------------------------

    def measure(self, fn: Callable, *args, **kwargs):
        """Call ``fn`` and wait until its outputs are ready; returns
        ``(out, t0, t1)`` on ``time.monotonic()``."""
        t0 = time.monotonic()
        out = _block_until_ready(fn(*args, **kwargs))
        return out, t0, time.monotonic()

    def record(self, name: str, modeled_s: float, measured_s: float,
               t0: float = 0.0, t1: float = 0.0, **attrs):
        self.records.append(StepTiming(name=name, modeled_s=float(modeled_s),
                                       measured_s=float(measured_s),
                                       t0=t0, t1=t1, attrs=attrs))

    def step(self, name: str, modeled_s: float, fn: Callable,
             *args, **kwargs):
        """Measure one call of ``fn`` against its modeled price."""
        window = self.profiler is not None and self.trace_calls is not None
        i = len(self.records)     # this call's index in the session
        if window and i == 1:
            self._start()
            window = self._tracing
        traced = window and self._tracing
        out, t0, t1 = self.measure(fn, *args, **kwargs)
        if traced:
            self.record(name, modeled_s, t1 - t0, t0, t1, traced=True)
        else:
            self.record(name, modeled_s, t1 - t0, t0, t1)
        if window and i == self.trace_calls:
            self._stop()
        return out

    def wrap(self, fn: Callable, name: str,
             modeled_s: Union[float, Callable[..., float]]) -> Callable:
        """A call-compatible wrapper of ``fn`` that records every call.

        ``modeled_s`` is a constant price or a ``(*args, **kwargs) ->
        seconds`` callable evaluated per call. ``functools.wraps``
        preserves ``__wrapped__``, so tag-reading consumers
        (``local_sgd.sync_step_tags``) still see through the wrapper.
        """

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            price = (modeled_s(*args, **kwargs) if callable(modeled_s)
                     else modeled_s)
            return self.step(name, price, fn, *args, **kwargs)

        return wrapped

    # -- reporting ----------------------------------------------------------

    def skew_table(self) -> List[dict]:
        """Per-name totals: every profiled span carries both modeled and
        measured seconds; ``skew = measured / modeled``."""
        by: Dict[str, dict] = {}
        for r in self.records:
            row = by.setdefault(r.name, {"name": r.name, "calls": 0,
                                         "modeled_s": 0.0, "measured_s": 0.0})
            row["calls"] += 1
            row["modeled_s"] += r.modeled_s
            row["measured_s"] += r.measured_s
        out = []
        for name in sorted(by):
            row = by[name]
            row["skew"] = (row["measured_s"] / row["modeled_s"]
                           if row["modeled_s"] > 0 else float("inf"))
            out.append(row)
        return out

    def emit_spans(self, tracer, track: str = "profiler"):
        """Wall-clock ``profile.<name>`` spans, one per measured call,
        attrs carrying both timelines (``modeled_s`` / ``measured_s`` /
        ``skew``). Kept off the virtual/modeled clocks so measured time
        never enters the deterministic fingerprints."""
        if not tracer:
            return
        for r in self.records:
            tracer.add(f"profile.{r.name}", r.t0, r.t1, cat=CAT_COMPUTE,
                       track=track, clock=WALL,
                       attrs=dict(r.attrs, modeled_s=r.modeled_s,
                                  measured_s=r.measured_s, skew=r.skew))


def format_skew_table(rows: List[dict]) -> str:
    """Render ``skew_table()`` rows as an aligned text table."""
    if not rows:
        return "(no profiled steps)"
    lines = [f"{'step':<16} {'calls':>6} {'modeled_s':>12} "
             f"{'measured_s':>12} {'skew':>8}"]
    for r in rows:
        lines.append(f"{r['name']:<16} {r['calls']:>6d} "
                     f"{r['modeled_s']:>12.4e} {r['measured_s']:>12.4e} "
                     f"{r['skew']:>8.2f}")
    return "\n".join(lines)
