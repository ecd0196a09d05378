"""Span tracing — the timeline half of ``repro_torch.obs``.

A ``Tracer`` records *spans*: named, attributed intervals on one of three
clock domains, nested into a tree by a begin/end stack:

  wall      measured seconds on ``wall_now()``, the clock the torch
            profiler stamps its events with (context-manager spans —
            stage execution, jit chunk calls, sync-step calls);
  virtual   the discrete-event runtime's modeled clock
            (``runtime.clock.Clock``) — client compute windows, uploads,
            per-leaf streaming arrivals, merges;
  modeled   the engine ledger's serial α–β timeline — per-round
            ``reduce[hop]`` / ``reduce_leaf[leaf]`` spans whose byte/second
            attributes reconcile with ``EngineReport.hop_costs`` /
            ``leaf_costs`` by construction.

Span taxonomy (see docs/observability.md for the full attribute table):
``run`` > ``stage`` > {``local_steps``, ``round`` > ``reduce`` >
``reduce_leaf``, ``broadcast``, ``merge``}.

Zero overhead when disabled: the module-level ``NULL_TRACER`` is falsy and
every emission site guards with ``if tracer: ...`` — a disabled run
executes one truthiness check per would-be span and allocates nothing.

Profiler ranges: ``layer(name)`` is the program's one kind of range at a
layer boundary (``local_sgd.*``, ``ssd.*``, ``flash_attention.*``,
``moe.*``, ``driver.*``). While a torch profiler records it is a host op
named ``name`` (``_Range``), so the profile charges the kernels launched
inside it to ``name``; otherwise it is a shared no-op, one check of the
profiler's state. A wall span opens ``layer(f"{track}.{name}")`` too, as
does ``NullTracer.span`` while a profiler records, so the driver's and
the engine's spans (``driver.local_steps``, ``driver.reduce``,
``engine.stage``) show in a profile with or without a ``Tracer``, on the
same timeline as the ``Tracer``'s wall spans.

Determinism: spans on the ``virtual`` and ``modeled`` clocks are a pure
function of (config, seeds) — same run ⇒ identical span tree including
timestamps (the property tests/test_obs.py pins); ``wall`` spans keep the
same tree *structure* but measured durations, and their fingerprint
leaves out the attrs that hold a measured time (``MEASURED_ATTRS``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

WALL = "wall"
VIRTUAL = "virtual"
MODELED = "modeled"
CLOCKS = (WALL, VIRTUAL, MODELED)

# attrs of a wall span that hold a measured time, left out of ``Span.key()``
# with its timestamps: a reduce span's ``device_ms``, a profiled call's
# ``measured_s`` and the ``skew`` derived from it
MEASURED_ATTRS = frozenset({"device_ms", "measured_s", "skew"})

# phase categories — the Chrome-trace color key (obs.export maps them)
CAT_COMPUTE = "compute"   # local SGD steps
CAT_COMM = "comm"         # uploads / reduces / broadcasts
CAT_CONTROL = "control"   # stages, rounds, barriers
CAT_MERGE = "merge"       # server-side merges (async arrival application)


@dataclass
class Span:
    """One recorded interval.

    ``t0``/``t1`` are seconds on the span's ``clock`` domain; ``track``
    names the Perfetto row the span renders on (``"engine"``,
    ``"client/3"``, ``"leaf/2"``, ``"server"``, …); ``parent`` is the
    index of the enclosing span in ``Tracer.spans`` (−1 at the root).
    """

    id: int
    parent: int
    name: str
    cat: str
    track: str
    clock: str
    t0: float
    t1: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def key(self):
        """Structural identity used by the determinism tests: everything
        except wall-clock timestamps and a wall span's measured attrs
        (wall spans compare structurally, virtual/modeled spans
        timestamp-exactly)."""
        wall = self.clock == WALL
        ts = (None, None) if wall else (self.t0, self.t1)
        return (self.id, self.parent, self.name, self.cat, self.track,
                self.clock) + ts + (tuple(sorted(
                    (k, v) for k, v in self.attrs.items()
                    if not (wall and k in MEASURED_ATTRS))),)


class _NoopSpan:
    """Reusable no-op context manager returned by the null tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP_SPAN = _NoopSpan()


def wall_now() -> float:
    """Seconds on the wall clock: ``CLOCK_REALTIME``, which the torch
    profiler stamps its events with, so wall spans and a profile of one
    run share a timeline."""
    return time.time_ns() / 1e9


class _Range:
    """A profiler range that takes a span's ``set`` and ignores it.

    A ``RecordFunctionFast`` op, not a ``record_function`` range: a
    ``record_function`` is a user annotation, and the profiler links a
    kernel to the innermost op that is not one, so a kernel launched
    outside any aten op (the port's own kernels, launched through
    ``ctypes``) would be linked to no range."""

    __slots__ = ("_op",)

    def __init__(self, name: str):
        self._op = _RecordFunctionFast(name)

    def __enter__(self):
        self._op.__enter__()
        return self

    def __exit__(self, *exc):
        self._op.__exit__(*exc)
        return False

    def set(self, **attrs):
        return self


def layer(name: str):
    """A profiler range named ``name`` while a torch profiler records (on
    this thread, or on the autograd thread a backward runs on), else the
    shared no-op."""
    if _profiler_enabled():
        return _Range(name)
    return _NOOP_SPAN


class NullTracer:
    """Disabled tracer: falsy, allocation-free, every method a no-op.

    Call sites keep the pattern ``if tracer: tracer.add(...)`` for hot
    loops and may call ``tracer.span(...)`` unconditionally (it returns a
    shared no-op context manager).
    """

    enabled = False
    spans: List[Span] = []

    def __bool__(self) -> bool:
        return False

    def span(self, name, *a, track: str = "engine", **kw):
        """The no-op; while a profiler records, the ``{track}.{name}``
        range the same span of a ``Tracer`` would open."""
        if _profiler_enabled():
            return _Range(f"{track}.{name}")
        return _NOOP_SPAN

    def add(self, *a, **kw):
        return None

    def instant(self, *a, **kw):
        return None

    def begin(self, *a, **kw):
        return None

    def end(self, *a, **kw):
        return None


NULL_TRACER = NullTracer()


class _WallSpan:
    """Context manager measuring one wall-clock span on a Tracer, inside
    its ``{track}.{name}`` profiler range."""

    __slots__ = ("tracer", "name", "cat", "track", "attrs", "_id", "_range")

    def __init__(self, tracer, name, cat, track, attrs):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.attrs = attrs

    def __enter__(self):
        self._range = layer(f"{self.track}.{self.name}")
        self._range.__enter__()
        self._id = self.tracer._open(self.name, self.cat, self.track,
                                     WALL, wall_now(), self.attrs)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self._id, wall_now())
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. rounds executed)."""
        self.tracer.spans[self._id].attrs.update(attrs)
        return self


class Tracer:
    """Span recorder. Truthy; spans accumulate in ``self.spans`` in
    creation order (ids are list indices — stable and deterministic).

    Three emission styles:
      * ``with tracer.span("stage", ...):`` — wall-clock interval;
      * ``tracer.add("reduce", t0, t1, clock=MODELED, ...)`` — explicit
        timestamps on the virtual/modeled clocks;
      * ``tracer.begin/``end`` — explicit-time nesting for callers that
        interleave spans across clients (the event replay).
    Nesting: ``span``/``begin`` push onto one stack; ``add``/``instant``
    attach to whatever span is currently open.
    """

    def __init__(self, run_id: Optional[str] = None):
        self.run_id = run_id
        self.spans: List[Span] = []
        self._stack: List[int] = []

    enabled = True

    def __bool__(self) -> bool:
        return True

    # -- internals ----------------------------------------------------------

    def _open(self, name, cat, track, clock, t0, attrs) -> int:
        sid = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        self.spans.append(Span(id=sid, parent=parent, name=name, cat=cat,
                               track=track, clock=clock, t0=float(t0),
                               t1=float(t0), attrs=dict(attrs or {})))
        self._stack.append(sid)
        return sid

    def _close(self, sid: int, t1: float):
        self.spans[sid].t1 = float(t1)
        # close any children left open (defensive; normal use pops sid)
        while self._stack and self._stack[-1] != sid:
            self._stack.pop()
        if self._stack:
            self._stack.pop()

    # -- public API ---------------------------------------------------------

    def span(self, name: str, *, cat: str = CAT_CONTROL,
             track: str = "engine", attrs: Optional[dict] = None
             ) -> _WallSpan:
        """Wall-clock context-manager span (nested via the begin stack)."""
        return _WallSpan(self, name, cat, track, attrs)

    def begin(self, name: str, t0: float, *, cat: str = CAT_CONTROL,
              track: str = "engine", clock: str = VIRTUAL,
              attrs: Optional[dict] = None) -> int:
        """Open an explicit-time span; returns its id for ``end``."""
        return self._open(name, cat, track, clock, t0, attrs)

    def end(self, sid: int, t1: float):
        """Close a span opened with ``begin``."""
        self._close(sid, t1)

    def add(self, name: str, t0: float, t1: float, *,
            cat: str = CAT_COMM, track: str = "engine",
            clock: str = VIRTUAL, attrs: Optional[dict] = None) -> int:
        """Record one complete explicit-time span (child of the currently
        open span, if any)."""
        sid = self._open(name, cat, track, clock, t0, attrs)
        self._close(sid, t1)
        return sid

    def instant(self, name: str, t: float, *, cat: str = CAT_CONTROL,
                track: str = "engine", clock: str = VIRTUAL,
                attrs: Optional[dict] = None) -> int:
        """Zero-duration marker (e.g. ``broadcast`` at the merge point)."""
        return self.add(name, t, t, cat=cat, track=track, clock=clock,
                        attrs=attrs)

    # -- views --------------------------------------------------------------

    def find(self, name: str, clock: Optional[str] = None) -> List[Span]:
        """All spans named ``name`` (optionally on one clock domain)."""
        return [s for s in self.spans if s.name == name
                and (clock is None or s.clock == clock)]

    def children(self, span: Span) -> Iterator[Span]:
        return (s for s in self.spans if s.parent == span.id)

    def tree_keys(self) -> list:
        """Deterministic structural fingerprint of the whole span tree —
        what the same-seed ⇒ same-trace tests compare (wall timestamps
        excluded, virtual/modeled timestamps included)."""
        return [s.key() for s in self.spans]
