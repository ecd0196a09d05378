"""Readings for the check's limits, on the card at a cell's own size.

  python3 bench/calibrate.py --workload <cell> --seeds <first> <count> \
      --control <count>

For each of ``count`` seeds from ``first`` it runs the cell's set-up and a
one-step window (``harness.run_cell`` with no seconds to measure) and
prints the check's numbers; for the first ``--control`` seeds it also
runs the control (``reference/control.py``: the reference with float8
products) and prints its numbers against the float32 reference, and for
the first ``--faults`` seeds the run with each fault of ``faults.py``
(or those ``--fault`` names) planted under the timed path. The
limits in ``bench/limits/<cell>.json`` lie between the largest program
reading and the smallest control reading; the benchmark's own runs never
run the control. The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path.cwd()
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)


def control_numbers(cell, seed: int, device) -> dict:
    from bench import check
    from bench.reference import control
    from bench.reference import train as R

    ref = R.readings(cell.model, cell.traffic, cell.train, seed, device)
    ctl = R.readings(cell.model, cell.traffic, cell.train, seed, device,
                     control.fp8_matmul)
    ctl["round"] = [ctl["round"]] * cell.traffic["clients"]
    numbers, detail = check.compare(ctl, ref)
    print(f"[calibrate] control seed {seed} by step and leaf: "
          f"{check.brief(detail)}", file=sys.stderr, flush=True)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    metavar=("FIRST", "COUNT"))
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0, metavar="COUNT",
                    help="also plant each fault of bench/faults.py on the "
                         "first COUNT seeds")
    ap.add_argument("--fault", nargs="+", default=None,
                    help="the faults to plant (default: every one)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench import check, faults, harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(ROOT, args.workload)
    # every number read, none held: the readings are what limits are set
    # from
    cell.limits = {k: math.inf for k in check.NUMBERS}
    first, count = args.seeds
    program, controls = [], []
    for seed in range(first, first + count):
        t0 = time.monotonic()
        out = harness.run_cell(cell, seed, 0.0, False, "cuda:0", t0)
        nums = {k: v["value"] for k, v in out["check"].items()}
        program.append(nums)
        print(json.dumps({"seed": seed, "side": "program", **nums,
                          "setup_s": out["metrics"]["setup_s"]["value"],
                          "s": time.monotonic() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in range(first, first + args.control):
        t0 = time.monotonic()
        nums = control_numbers(cell, seed, torch.device("cuda:0"))
        controls.append(nums)
        print(json.dumps({"seed": seed, "side": "control", **nums,
                          "s": time.monotonic() - t0}), flush=True)
        torch.cuda.empty_cache()
    planted = {}
    for name in args.fault or faults.FAULTS:
        fault = faults.FAULTS[name]
        for seed in range(first, first + args.faults):
            t0 = time.monotonic()
            with faults.planted(fault):
                out = harness.run_cell(cell, seed, 0.0, False, "cuda:0", t0)
            nums = {k: v["value"] for k, v in out["check"].items()}
            planted.setdefault(name, []).append(nums)
            print(json.dumps({"seed": seed, "side": name, **nums,
                              "s": time.monotonic() - t0}), flush=True)
            torch.cuda.empty_cache()
    summary = {"workload": args.workload,
               "program_max": ({k: max(p[k] for p in program)
                                for k in check.NUMBERS} if program else {}),
               "control_min": ({k: min(c[k] for c in controls)
                                for k in check.NUMBERS} if controls else {}),
               "faults_min": {f: {k: min(r[k] for r in rs)
                                  for k in check.NUMBERS}
                              for f, rs in planted.items()},
               "s": time.monotonic() - T_START}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
