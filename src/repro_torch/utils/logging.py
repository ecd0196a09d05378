"""Structured JSONL logging (stdout, no deps).

Every log record is one JSON line:

    {"ts": <unix seconds>, "mono_s": <time.monotonic()>, "level": "info",
     "logger": "stl_sgd", "run_id": "a1b2c3d4", "event": "stage_done",
     ...fields}

plus ``"virtual_time_s"`` when the logger is bound to a virtual clock
(``bind_clock`` — the event runtime's ``runtime.clock.Clock``), so
progress lines from a discrete-event run carry both the host's monotonic
timestamp and the run's modeled time.

``repro_torch.obs`` and the engine stack report progress through this logger
(``Engine.run`` / ``StagewiseDriver`` stage events); the legacy printf
style (``log.info("stage %d", s)``) still works — the formatted text
lands in the ``msg`` field — so call sites migrate incrementally.

Level filtering: ``REPRO_LOG_LEVEL`` env var (debug|info|warning|error,
default info). ``quiet()`` silences a logger for tests.

Sampling / rate limiting: ``log.limit(every_n=..., max_per_s=...)`` keeps
event-runtime logs O(windows) instead of O(events) at cohort scale —
``every_n`` emits one record in n per (level, event) key; ``max_per_s``
caps records per second of the bound virtual clock (host monotonic time
when no clock is bound). Suppression is never silent: dropped records
are counted into the ``log.dropped_lines`` obs counter (labelled by
logger) and the next emitted record carries the cumulative ``dropped``
count since the last one that made it out. Warnings and errors always
bypass the limiter.
"""
from __future__ import annotations

import json
import os
import sys
import time
import uuid
from typing import Any, Dict, Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

# one run id per process: every record of one invocation correlates
RUN_ID = uuid.uuid4().hex[:8]


class StructuredLogger:
    """One named JSONL event stream.

    ``event(level, event, **fields)`` is the primitive; ``debug`` /
    ``info`` / ``warning`` / ``error`` are sugar. Fields must be
    JSON-serializable (everything else is stringified).
    """

    def __init__(self, name: str, stream=None, level: Optional[str] = None,
                 run_id: Optional[str] = None):
        self.name = name
        self.stream = stream if stream is not None else sys.stdout
        lvl = level or os.environ.get("REPRO_LOG_LEVEL", "info")
        self.level = _LEVELS.get(lvl.lower(), 20)
        self.run_id = run_id or RUN_ID
        self._clock = None
        # sampling / rate limiting (see limit())
        self._every_n: Optional[int] = None
        self._max_per_s: Optional[float] = None
        self._seen: Dict[tuple, int] = {}
        self._bucket: Optional[int] = None
        self._bucket_n = 0
        self._dropped_pending = 0
        self.dropped_total = 0

    def bind_clock(self, clock) -> "StructuredLogger":
        """Attach a virtual-time source: anything with a ``.now`` seconds
        attribute (``runtime.clock.Clock``) or a 0-arg callable. Records
        then carry ``virtual_time_s``."""
        self._clock = clock
        return self

    def quiet(self) -> "StructuredLogger":
        """Disable output (tests, library consumers)."""
        self.level = 10 ** 9
        return self

    def limit(self, every_n: Optional[int] = None,
              max_per_s: Optional[float] = None) -> "StructuredLogger":
        """Sample / rate-limit records below warning level.

        ``every_n``: emit the 1st of every n records per (level, event)
        key. ``max_per_s``: at most that many records per second of the
        bound virtual clock (host monotonic without one). Drops are
        counted (``log.dropped_lines`` obs counter + a ``dropped`` field
        on the next emitted record). ``limit()`` clears both.
        """
        self._every_n = every_n if every_n and every_n > 1 else None
        self._max_per_s = max_per_s if max_per_s and max_per_s > 0 else None
        self._seen.clear()
        self._bucket, self._bucket_n = None, 0
        return self

    def _now_s(self) -> float:
        vt = self._virtual_now()
        return vt if vt is not None else time.monotonic()

    def _drop(self):
        self._dropped_pending += 1
        self.dropped_total += 1
        try:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.registry().counter(
                "log.dropped_lines", unit="records",
                help="log records suppressed by limit()").inc(
                    logger=self.name)
        except Exception:
            pass  # never let accounting break logging

    def _limited(self, level: str, event: str) -> bool:
        """True when this record is suppressed by the limiter."""
        if self._every_n is None and self._max_per_s is None:
            return False
        if _LEVELS.get(level, 20) >= _LEVELS["warning"]:
            return False
        if self._every_n is not None:
            k = (level, event)
            n = self._seen.get(k, 0)
            self._seen[k] = n + 1
            if n % self._every_n != 0:
                self._drop()
                return True
        if self._max_per_s is not None:
            bucket = int(self._now_s() * self._max_per_s)
            if bucket != self._bucket:
                self._bucket, self._bucket_n = bucket, 0
            if self._bucket_n >= 1:
                self._drop()
                return True
            self._bucket_n += 1
        return False

    def _virtual_now(self) -> Optional[float]:
        c = self._clock
        if c is None:
            return None
        now = getattr(c, "now", None)
        if now is None and callable(c):
            now = c()
        return float(now) if now is not None else None

    def event(self, level: str, event: str, *args,
              **fields: Any) -> Optional[Dict[str, Any]]:
        """Emit one record. Legacy printf compat: when ``args`` is
        non-empty, ``event`` is treated as a %-format string and the
        rendered text becomes the ``msg`` field of a generic ``"log"``
        event."""
        if _LEVELS.get(level, 20) < self.level:
            return None
        if args:
            fields = dict(fields, msg=event % args)
            event = "log"
        if self._limited(level, event):
            return None
        if self._dropped_pending:
            fields = dict(fields, dropped=self._dropped_pending)
            self._dropped_pending = 0
        rec: Dict[str, Any] = {"ts": round(time.time(), 6),
                               "mono_s": round(time.monotonic(), 6),
                               "level": level, "logger": self.name,
                               "run_id": self.run_id, "event": event}
        vt = self._virtual_now()
        if vt is not None:
            rec["virtual_time_s"] = vt
        rec.update(fields)
        self.stream.write(json.dumps(rec, default=str) + "\n")
        flush = getattr(self.stream, "flush", None)
        if flush:
            flush()
        return rec

    def debug(self, event: str, *args, **fields):
        return self.event("debug", event, *args, **fields)

    def info(self, event: str, *args, **fields):
        return self.event("info", event, *args, **fields)

    def warning(self, event: str, *args, **fields):
        return self.event("warning", event, *args, **fields)

    def error(self, event: str, *args, **fields):
        return self.event("error", event, *args, **fields)


_loggers: Dict[str, StructuredLogger] = {}


def get_logger(name: str) -> StructuredLogger:
    """Process-cached structured logger (one per name)."""
    if name not in _loggers:
        _loggers[name] = StructuredLogger(name)
    return _loggers[name]
