"""The benchmark's command: one run of one cell on the card.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It loads ``BENCHMARK.json``, runs the
cell (``bench/harness.py``): set-up, a window of ``--seconds``, the check
against the plain reference, and prints the result as one JSON object on
the last line of standard output, with the compared numbers and their
limits as the last lines of standard error. With ``--trace 1`` it reports
the cell's per-layer metrics from a profiled stretch of the window.

It refuses to run (exit 2, no result) without a CUDA card or with fewer
cards than the cell asks for, and fails (exit 3, no result) if JAX or the
JAX package was loaded in its process.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# the script's own folder is not a package root: its modules must not
# shadow the standard library's (``trace``)
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``: names compare whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(x):
    """The object with every non-finite float as a string, so that the
    line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of the run stay in the checkout, at fixed paths
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from bench import spec

    cell = spec.cell(ROOT, args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    print(f"[bench] {args.workload} seed {args.seed}, {args.seconds} s, "
          f"trace {args.trace}; card: {card_line()}", file=sys.stderr,
          flush=True)

    from bench import harness

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded in this process: {bad}; the benchmark runs "
              f"without JAX and the JAX package", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
