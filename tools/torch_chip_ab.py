#!/usr/bin/env python3
"""Time the port's training kernels, training slice and SSD layer on two
checkouts, in turns, on one CUDA card.

    python3 tools/torch_chip_ab.py --parent DIR [--out DIR] [--topk]

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

With ``--topk`` each process instead times one top-k round on the device
route (``topk_round_ms``), and on this checkout also the top-k
selection's tie scan in its two forms (``tie_scan_ms``).

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


def topk_round_ms(torch, cs) -> float:
    """One top-k round on the device route: qwen3-14b SMOKE in float32,
    two clients whose params differ by seeded noise, 14 leaves; the median
    of ``cs.TOPK_RUN["reps"]`` rounds, CUDA events around each."""
    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd as LS
    from repro_torch.utils.tree import tree_map

    dev = torch.device("cuda:0")
    cfg = get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(0)
    state = LS.init_state(0, cfg, 2, device=dev)
    state = dict(state, params=tree_map(
        lambda p: p + 0.01 * torch.randn(p.shape, generator=g, device=dev,
                                         dtype=p.dtype), state["params"]))
    _, sync, _ = LS.build_train_steps(cfg, dev, reducer="topk")
    box = [state]

    def round_():
        box[0] = sync(box[0])

    return cs.call_ms(torch, round_, cs.TOPK_RUN["reps"])


def tie_scan_ms(torch, cs) -> dict:
    """The rank of each tied element in its row (``comm/reducer.py::
    _first_ties``) on two rows of qwen3-14b's embedding leaf, a random
    bool (2, 778,567,680): ``cumsum`` over dim 1 of the batch, and one
    ``cumsum`` a row."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import padded_vocab

    cfg = get_arch("qwen3-14b")
    cols = padded_vocab(cfg) * cfg.d_model
    g = torch.Generator(device="cuda:0").manual_seed(0)
    tied = torch.randint(0, 2, (2, cols), generator=g, device="cuda:0",
                         dtype=torch.uint8).bool()
    rank = torch.empty(tied.shape, dtype=torch.int32, device="cuda:0")

    def rows():
        for r in range(tied.shape[0]):
            torch.cumsum(tied[r], dim=0, dtype=torch.int32, out=rank[r])

    return {"shape": [2, cols],
            "batched": cs.call_ms(torch, lambda: torch.cumsum(
                tied, dim=1, dtype=torch.int32), cs.TOPK_RUN["reps"]),
            "a_row_at_a_time": cs.call_ms(torch, rows, cs.TOPK_RUN["reps"])}


def topk_worker(root: Path, out: Path) -> int:
    import chip_smoke as cs
    import torch

    res = {"root": str(root), "card": cs.nvidia_smi_line(),
           "topk_round_ms": topk_round_ms(torch, cs)}
    if root == ROOT:
        res["tie_scan_ms"] = tie_scan_ms(torch, cs)
    cs.log(f"[ab] {json.dumps(res)}")
    out.write_text(json.dumps(res, indent=1))
    return 0


def worker(root: Path, out: Path, topk: bool = False) -> int:
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
    if topk:
        return topk_worker(root, out)
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
    ap.add_argument("--topk", action="store_true",
                    help="time only the top-k round and its tie scan")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker.resolve(), args.worker_out, args.topk)
    if args.parent is None:
        ap.error("--parent is required")
    args.out.mkdir(parents=True, exist_ok=True)
    order = [("parent", args.parent.resolve()), ("change", ROOT),
             ("change", ROOT), ("parent", args.parent.resolve())]
    for i, (label, root) in enumerate(order):
        print(f"[ab] run {i}: {label} ({root})", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                             "--worker-out",
                             str(args.out / f"{i}_{label}.json")]
                            + ["--topk"] * args.topk).returncode
        if rc != 0:
            print(f"[ab] run {i} ({label}) failed with {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
