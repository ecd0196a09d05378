"""Span export: JSONL logs and Chrome-trace / Perfetto JSON timelines.

The port of ``src/repro/obs/export.py``: the same records and events from
the same spans (only ``otherData.producer`` names this package).

Serializations of a ``Tracer``'s span list (plus ``obs.series`` curves):

  * ``write_jsonl`` / ``read_jsonl`` — one JSON object per span (the raw
    log; greppable, diffable, append-friendly). The pair round-trips:
    ``read_jsonl(write_jsonl(tracer, p))`` reconstructs identical
    ``Span`` objects, so CI trace artifacts can be re-exported to
    Perfetto offline;
  * ``to_chrome_trace`` / ``write_chrome_trace`` — the Chrome Trace Event
    Format (JSON object with a ``traceEvents`` list) that
    https://ui.perfetto.dev opens directly. Each clock domain becomes one
    Perfetto *process* ("virtual clock", "modeled α–β timeline", "wall
    clock"), each span track one named *thread* row (``client/3``,
    ``leaf/2``, ``server``, …), spans are complete ("X") events colored
    by phase category, and span attributes land in ``args`` so clicking a
    ``reduce_leaf`` slice shows its leaf path, payload bytes and modeled
    seconds. Pass ``series=`` (a ``SeriesRegistry`` or list of
    ``Series``) to additionally render each series as a *counter track*
    ("C" events) inside its clock's process — queue depth, batch
    occupancy and tokens/s curves sit directly under the span waterfall
    that explains them.

Timestamps: Chrome traces count microseconds; all tracer clocks count
seconds, so every t0/duration is scaled by 1e6. Virtual/modeled traces
start at 0 by construction; wall spans (and wall series samples) are
rebased to the earliest wall timestamp so the three processes align at
t=0.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.obs.trace import (
    CAT_COMM,
    CAT_COMPUTE,
    CAT_CONTROL,
    CAT_MERGE,
    MODELED,
    VIRTUAL,
    WALL,
    Span,
    Tracer,
)

# clock domain -> (pid, Perfetto process name)
_PROCESSES = {
    VIRTUAL: (1, "virtual clock (event runtime)"),
    MODELED: (2, "modeled α–β timeline (engine ledger)"),
    WALL: (3, "wall clock (host)"),
}

# phase category -> Chrome reserved color name ("spans colored by phase")
_CNAME = {
    CAT_COMPUTE: "thread_state_running",   # green
    CAT_COMM: "rail_response",             # blue
    CAT_MERGE: "rail_animation",           # purple
    CAT_CONTROL: "grey",
}


def _spans(source: Union[Tracer, List[Span]]) -> List[Span]:
    return source.spans if isinstance(source, Tracer) else list(source)


def span_record(s: Span) -> dict:
    """One span as a plain JSON-serializable dict (the JSONL row)."""
    return {"id": s.id, "parent": s.parent, "name": s.name, "cat": s.cat,
            "track": s.track, "clock": s.clock, "t0": s.t0, "t1": s.t1,
            "attrs": s.attrs}


def write_jsonl(source: Union[Tracer, List[Span]], path: str) -> str:
    """Write the span log as JSON Lines (one span per line, id order)."""
    with open(path, "w") as f:
        for s in _spans(source):
            f.write(json.dumps(span_record(s), sort_keys=True,
                               default=str) + "\n")
    return path


def read_jsonl(path: str) -> List[Span]:
    """Load a ``write_jsonl`` span log back into ``Span`` objects.

    The inverse of ``span_record``: a written log reads back into spans
    whose ``key()`` fingerprints match the originals (for
    JSON-representable attribute values — anything else was stringified
    on write), so CI ``.jsonl`` artifacts re-export to Perfetto offline:
    ``write_chrome_trace(read_jsonl(p), out)``.
    """
    spans: List[Span] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            spans.append(Span(id=int(d["id"]), parent=int(d["parent"]),
                              name=d["name"], cat=d["cat"],
                              track=d["track"], clock=d["clock"],
                              t0=float(d["t0"]), t1=float(d["t1"]),
                              attrs=dict(d.get("attrs") or {})))
    return spans


def _series_list(series) -> list:
    """Normalize the ``series=`` argument: None, one Series, a list, or a
    SeriesRegistry (anything iterable yielding Series)."""
    if series is None:
        return []
    if hasattr(series, "samples") and hasattr(series, "clock"):
        return [series]
    return list(series)


def _track_ids(spans: List[Span]) -> Dict[Tuple[str, str], int]:
    """(clock, track) -> tid, assigned in sorted-name order per clock so
    Perfetto rows come out grouped and deterministic (server/engine rows
    first, then client/…, leaf/… lexicographically)."""
    tids: Dict[Tuple[str, str], int] = {}
    by_clock: Dict[str, set] = {}
    for s in spans:
        by_clock.setdefault(s.clock, set()).add(s.track)
    for clock, tracks in by_clock.items():
        for i, track in enumerate(sorted(tracks)):
            tids[(clock, track)] = i + 1
    return tids


def to_chrome_trace(source: Union[Tracer, List[Span]],
                    run_id: Optional[str] = None,
                    series=None) -> dict:
    """Render spans (and optional series) as a Chrome Trace Event object.

    Load the written file at https://ui.perfetto.dev (or
    chrome://tracing): one process per clock domain, one thread row per
    span track, durations in microseconds, attributes under ``args``.
    ``series`` (a ``SeriesRegistry``, a list of ``Series``, or one
    ``Series``) adds one counter track per series — "C" events named by
    the series, one sample per recorded ``(t, value)``, in the process
    of the series' clock so counters align with the span timestamps.
    """
    spans = _spans(source)
    srs = _series_list(series)
    if run_id is None and isinstance(source, Tracer):
        run_id = source.run_id
    tids = _track_ids(spans)
    wall0 = min((s.t0 for s in spans if s.clock == WALL), default=None)
    if wall0 is None:
        wall0 = min((t for sr in srs if sr.clock == WALL
                     for t, _ in sr.samples()), default=0.0)
    events: List[dict] = []
    seen_proc = set()
    for (clock, track), tid in sorted(tids.items(),
                                      key=lambda kv: (kv[0][0], kv[1])):
        pid, pname = _PROCESSES[clock]
        if pid not in seen_proc:
            seen_proc.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": track}})
    for sr in srs:
        pid, pname = _PROCESSES[sr.clock]
        if pid not in seen_proc:
            seen_proc.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
        base = wall0 if sr.clock == WALL else 0.0
        for t, v in sr.samples():
            events.append({"ph": "C", "name": sr.name, "pid": pid,
                           "tid": 0, "ts": (t - base) * 1e6,
                           "args": {"value": v}})
    for s in spans:
        pid, _ = _PROCESSES[s.clock]
        t0 = s.t0 - (wall0 if s.clock == WALL else 0.0)
        ev = {"ph": "X", "name": s.name, "cat": s.cat, "pid": pid,
              "tid": tids[(s.clock, s.track)],
              "ts": t0 * 1e6, "dur": max(s.t1 - s.t0, 0.0) * 1e6,
              "args": dict(s.attrs, span_id=s.id, clock=s.clock)}
        cname = _CNAME.get(s.cat)
        if cname:
            ev["cname"] = cname
        events.append(ev)
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"producer": "repro_torch.obs"}}
    if run_id:
        trace["otherData"]["run_id"] = run_id
    return trace


def write_chrome_trace(source: Union[Tracer, List[Span]], path: str,
                       run_id: Optional[str] = None, series=None) -> str:
    """Write ``to_chrome_trace`` output to ``path`` (Perfetto-loadable)."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(source, run_id=run_id, series=series), f,
                  default=str)
    return path
