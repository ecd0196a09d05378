"""BENCH_*.json loading, schema validation and numeric regression diffing.

The port of ``src/repro/obs/diff.py``, the same schema and rules, so both
packages judge one artifact alike. The perf-trajectory artifacts (schema
v1, as ``benchmarks.common.save_bench`` writes them) are the committed
performance baselines; this module is what ``tools/torch_bench_diff.py``
uses to compare a fresh run against them:

  * ``load_bench`` — parse + schema-validate one BENCH_*.json file
    (schema v1: ``{"bench", "schema", "meta", "rows"}``, rows a list of
    flat dicts);
  * ``diff_benches`` — match rows across two artifacts by their identity
    columns and flag any *monitored* numeric column (modeled comm bytes,
    modeled seconds, rounds, modeled wall-clock) that regressed beyond a
    configurable relative tolerance;
  * ``diff_dirs`` — the directory sweep CI runs: every artifact present
    in both trees is diffed; artifacts whose ``meta.scale`` differs are
    skipped (a smoke run must not be judged against a full-protocol
    baseline).

A *regression* is ``current > baseline × (1 + tol)`` — more modeled
bytes/seconds/rounds than the committed trajectory allows. Improvements
are reported (so the baseline can be re-committed) but never fail.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# columns that identify a row within its bench (whichever are present)
ID_KEYS = ("dataset", "net", "dist", "algo", "mode", "reducer", "schedule",
           "slowdown", "leaves", "arch", "shape", "program", "cell")

# monitored numeric columns: modeled comm bytes/seconds, round counts, the
# event runtime's modeled wall-clock, the serving driver's modeled latency
# percentiles and its total SLO-breach seconds — higher is worse for all
# of them (time-to-breach is higher-is-better and therefore NOT gated;
# the breach-seconds column catches the same saturation regressions)
DIFF_KEYS = ("comm_bytes", "comm_time_s", "rounds", "wall_clock_s",
             "blocking_s", "streaming_s", "p50_s", "p95_s", "p99_s",
             "slo_breach_s")


class BenchSchemaError(ValueError):
    """A BENCH_*.json file that does not match schema v1."""


def validate_bench(rec: dict, path: str = "<bench>") -> dict:
    """Validate one parsed BENCH record against schema v1; returns it
    (with ``meta`` defaulted) or raises ``BenchSchemaError``."""
    if not isinstance(rec, dict):
        raise BenchSchemaError(f"{path}: expected a JSON object, got "
                               f"{type(rec).__name__}")
    for key, typ in (("bench", str), ("schema", int), ("rows", list)):
        if key not in rec:
            raise BenchSchemaError(f"{path}: missing required key {key!r}")
        if not isinstance(rec[key], typ):
            raise BenchSchemaError(
                f"{path}: key {key!r} must be {typ.__name__}, got "
                f"{type(rec[key]).__name__}")
    if rec["schema"] != 1:
        raise BenchSchemaError(
            f"{path}: unsupported schema version {rec['schema']} "
            f"(this reader knows schema 1)")
    for i, row in enumerate(rec["rows"]):
        if not isinstance(row, dict):
            raise BenchSchemaError(f"{path}: rows[{i}] is not an object")
    rec.setdefault("meta", {})
    if not isinstance(rec["meta"], dict):
        raise BenchSchemaError(f"{path}: meta must be an object")
    return rec


def load_bench(path: str) -> dict:
    """Load + validate one BENCH_*.json artifact."""
    with open(path) as f:
        try:
            rec = json.load(f)
        except json.JSONDecodeError as e:
            raise BenchSchemaError(f"{path}: not valid JSON ({e})") from None
    return validate_bench(rec, path)


def row_key(row: dict) -> Tuple[Tuple[str, str], ...]:
    """Identity of one row: the present ID_KEYS columns, stringified."""
    return tuple((k, str(row[k])) for k in ID_KEYS if k in row)


def _num(row: dict, key: str) -> Optional[float]:
    v = row.get(key)
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class Delta:
    """One (row, column) comparison between baseline and current."""

    bench: str
    cell: str               # rendered row identity
    key: str                # monitored column name
    baseline: float
    current: float

    @property
    def ratio(self) -> float:
        return self.current / self.baseline if self.baseline else float(
            "inf") if self.current else 1.0

    def regressed(self, tol: float) -> bool:
        return self.current > self.baseline * (1.0 + tol) \
            and self.current - self.baseline > 1e-12

    def improved(self, tol: float) -> bool:
        return self.current < self.baseline * (1.0 - tol)

    def render(self) -> str:
        return (f"{self.bench} [{self.cell}] {self.key}: "
                f"{self.baseline:g} -> {self.current:g} "
                f"({self.ratio:.3f}x)")


def diff_benches(baseline: dict, current: dict, *,
                 keys: Sequence[str] = DIFF_KEYS) -> List[Delta]:
    """All monitored-column deltas between two validated BENCH records.

    Rows are matched by ``row_key``; rows present on only one side are
    ignored (coverage changes are not regressions). Columns missing on
    either side are skipped — pre-PR-1 artifacts without comm fields
    simply contribute no comm deltas.
    """
    base_rows: Dict[tuple, dict] = {row_key(r): r for r in baseline["rows"]}
    out: List[Delta] = []
    for row in current["rows"]:
        k = row_key(row)
        b = base_rows.get(k)
        if b is None:
            continue
        cell = " ".join(v for _, v in k) or "-"
        for key in keys:
            bv, cv = _num(b, key), _num(row, key)
            if bv is None or cv is None:
                continue
            out.append(Delta(bench=current.get("bench", "?"), cell=cell,
                             key=key, baseline=bv, current=cv))
    return out


@dataclass
class DirDiff:
    """Result of diffing a run directory against a baseline directory."""

    deltas: List[Delta]
    compared: List[str]     # artifact basenames diffed
    skipped: List[str]      # "<name>: reason" for unmatched/mismatched files

    def regressions(self, tol: float) -> List[Delta]:
        return [d for d in self.deltas if d.regressed(tol)]

    def improvements(self, tol: float) -> List[Delta]:
        return [d for d in self.deltas if d.improved(tol)]


def diff_dirs(baseline_dir: str, current_dir: str, *,
              keys: Sequence[str] = DIFF_KEYS,
              pattern: str = "BENCH_*.json") -> DirDiff:
    """Diff every BENCH artifact present in both directories.

    Artifacts are matched by basename. A file whose ``meta.scale``
    disagrees with its baseline is skipped (never silently compared):
    smoke/quick/full protocols produce incommensurable numbers.
    """
    deltas: List[Delta] = []
    compared: List[str] = []
    skipped: List[str] = []
    base_files = {os.path.basename(p): p for p in
                  glob.glob(os.path.join(baseline_dir, pattern))}
    cur_files = sorted(glob.glob(os.path.join(current_dir, pattern)))
    for cur_path in cur_files:
        name = os.path.basename(cur_path)
        base_path = base_files.get(name)
        if base_path is None:
            skipped.append(f"{name}: no baseline")
            continue
        base = load_bench(base_path)
        cur = load_bench(cur_path)
        bs = base["meta"].get("scale")
        cs = cur["meta"].get("scale")
        if bs is not None and cs is not None and bs != cs:
            skipped.append(f"{name}: scale mismatch "
                           f"(baseline {bs!r} vs current {cs!r})")
            continue
        deltas.extend(diff_benches(base, cur, keys=keys))
        compared.append(name)
    for name in sorted(set(base_files) - {os.path.basename(p)
                                          for p in cur_files}):
        skipped.append(f"{name}: baseline only (bench not run)")
    return DirDiff(deltas=deltas, compared=compared, skipped=skipped)
