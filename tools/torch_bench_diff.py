#!/usr/bin/env python
"""Compare fresh BENCH_*.json artifacts against committed baselines,
with the PyTorch port's ``repro_torch.obs.diff`` (no JAX needed).

    python tools/torch_bench_diff.py BASELINE_DIR CURRENT_DIR [--tol 0.05]
                                     [--keys comm_bytes,comm_time_s,...]

Exit status: 0 when no monitored column regressed beyond the tolerance,
1 when at least one did, 2 on schema/usage errors — the CI gate behind
the committed perf trajectory (benchmarks/results/).

What counts: rows are matched by identity columns (dataset, algo, mode,
reducer, schedule, …); the monitored numeric columns (modeled comm bytes,
modeled seconds, round counts, modeled wall-clock) regress when
``current > baseline × (1 + tol)``. Artifacts whose ``meta.scale``
disagrees are skipped — a smoke run is never judged against a
full-protocol baseline. Improvements are listed so the baseline can be
re-committed, but never fail the gate.
"""
from __future__ import annotations

import argparse
import os
import sys

# runnable from a checkout without installing:
# python tools/torch_bench_diff.py
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.obs.diff import (DIFF_KEYS, BenchSchemaError,  # noqa: E402
                                  diff_dirs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="diff BENCH_*.json artifacts against baselines "
                    "(nonzero exit on regression)")
    ap.add_argument("baseline_dir", help="committed baseline directory "
                                         "(e.g. benchmarks/results/smoke)")
    ap.add_argument("current_dir", help="fresh-run artifact directory "
                                        "(e.g. artifacts/bench)")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="relative regression tolerance (default 0.05 = 5%%)")
    ap.add_argument("--keys", default=",".join(DIFF_KEYS),
                    help="comma-separated monitored columns "
                         f"(default: {','.join(DIFF_KEYS)})")
    args = ap.parse_args(argv)

    keys = tuple(k for k in args.keys.split(",") if k)
    if not os.path.isdir(args.baseline_dir):
        print(f"torch_bench_diff: baseline directory {args.baseline_dir!r} "
              "does not exist", file=sys.stderr)
        return 2
    try:
        dd = diff_dirs(args.baseline_dir, args.current_dir, keys=keys)
    except BenchSchemaError as e:
        print(f"torch_bench_diff: {e}", file=sys.stderr)
        return 2

    for name in dd.compared:
        print(f"compared {name}")
    for reason in dd.skipped:
        print(f"skipped  {reason}")
    if not dd.compared:
        print("torch_bench_diff: no artifacts compared (nothing to gate on)")
        return 0

    regs = dd.regressions(args.tol)
    imps = dd.improvements(args.tol)
    for d in imps:
        print(f"improved   {d.render()}")
    for d in regs:
        print(f"REGRESSED  {d.render()}")
    print(f"torch_bench_diff: {len(dd.deltas)} cells compared, "
          f"{len(regs)} regression(s), {len(imps)} improvement(s) "
          f"at tol={args.tol:.0%}")
    return 1 if regs else 0


if __name__ == "__main__":
    raise SystemExit(main())
