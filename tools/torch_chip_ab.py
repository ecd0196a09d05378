#!/usr/bin/env python3
"""Time the port's training kernels, training slice and SSD layer on two
checkouts, in turns, on one CUDA card.

    python3 tools/torch_chip_ab.py --parent DIR [--out DIR]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). The checkouts run in the order parent, change, change, parent,
each in its own process that loads that checkout's ``repro_torch`` and
measures it with THIS checkout's ``chip_smoke.py``, so that both sides
are timed by the same code within one call:

  * phase 3: ``check_kernels`` at ``PHASE3_SHAPES`` (each kernel held to
    its plain version, timed from a cold L2) and, for each tree the slice
    steps, ``tree_update_ms`` (one launch per leaf on a per-leaf checkout,
    one in all on a multi-leaf one);
  * the SSD layer call's per-kernel profile, then phase 4's profile of
    logreg and the MLP (ms per local step, kernels per step, busy share,
    each training kernel's device time inside the step);
  * phase 8's layer case, and on this checkout also the layer from an
    initial state.

Each process writes its rows as JSON to ``OUT/<n>_<label>.json`` (``OUT``
defaults to ``artifacts/torch_chip_ab``); the log goes to standard output.
Exits non-zero if any process fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(root: Path, out: Path) -> int:
    # the checkout's package first: once imported, its modules load from
    # there, whatever chip_smoke puts on sys.path
    sys.path.insert(0, str(root / "src"))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != root / "src":
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"[ab] {root}: {cs.nvidia_smi_line()}")
    build.library()
    floor = cs.launch_floor_ms(torch)
    kern = cs.check_kernels(torch, cs.PHASE3_SHAPES, floor)
    trees = {label: cs.tree_update_ms(torch, *t)
             for label, t in cs.slice_trees(torch).items()}
    for label, ms in trees.items():
        cs.log(f"[ab] {label}: tree_sgd_update_ device {ms * 1e3:.2f} us")
    passes = cs.ssd_layer_kernels_ms(torch)
    x, y = cs.slice_data()
    profiles = {model: cs.profile_slice(torch, model, x, y)
                for model in ("logreg", "mlp")}
    labels = ("layer", "layer_init") if root == ROOT else ("layer",)
    ssd = cs.check_ssd(torch, passes, labels)
    out.write_text(json.dumps({
        "root": str(root), "card": cs.nvidia_smi_line(),
        "launch_floor_ms": floor,
        "kernels": {f"{k} | {s}": v for (k, s), v in kern.items()},
        "trees": trees, "profiles": profiles, "ssd": ssd}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the other checkout, run first and last")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "torch_chip_ab")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker.resolve(), args.worker_out)
    if args.parent is None:
        ap.error("--parent is required")
    args.out.mkdir(parents=True, exist_ok=True)
    order = [("parent", args.parent.resolve()), ("change", ROOT),
             ("change", ROOT), ("parent", args.parent.resolve())]
    for i, (label, root) in enumerate(order):
        print(f"[ab] run {i}: {label} ({root})", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                             "--worker-out",
                             str(args.out / f"{i}_{label}.json")]).returncode
        if rc != 0:
            print(f"[ab] run {i} ({label}) failed with {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
