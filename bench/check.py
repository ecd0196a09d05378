"""The comparison that decides ``correct``: the program's readings of its
first local steps and round against the plain reference's.

Each number is a worst relative gap:

* ``loss_gap``: over the steps, |L_program − L_ref| / |L_ref|;
* ``grad_gap``: over the clients and leaves, the gap between the norms of
  the first gradient, |‖g_program‖ − ‖g_ref‖|, against the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same of each client's change after three steps;
* ``round_gap``: the same of each replica's change after the round;
* ``grad_probe_gap``: over the clients and leaves, the gap between the
  first gradient's projections on a random normal vector, against the same
  norm: it reads the size of the difference of the two gradients, where a
  gap of norms reads only its square (a rounding error of random sign
  moves a norm little).

A cell compares the numbers its limits file names.

A leaf whose first gradient in the reference is under a thousandth of the
median leaf's is left out of the two changes: such a leaf moves by
round-off alone. A reading that is not finite is a gap of infinity.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "round_gap",
           "grad_probe_gap")
QUIET = 1e-3   # a leaf's gradient under this share of the median leaf's


def _gap(p: float, r: float, floor: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), floor, 1e-30)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> Dict[str, float]:
    """Each leaf's gap."""
    keys = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in keys)
    return {k: _gap(prog.get(k, math.nan), ref[k], floor) for k in keys}


def _worst(per_leaf) -> Dict[str, float]:
    """Leaf by leaf, the worst over clients or replicas."""
    out: Dict[str, float] = {}
    for gaps in per_leaf:
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def moved(ref: dict) -> set:
    """The leaves whose first gradient moves them in the reference (every
    client's gradient at least ``QUIET`` of the median leaf's)."""
    out = None
    for g in ref["grad"]:
        med = statistics.median(g.values())
        keep = {k for k, v in g.items() if v >= QUIET * med}
        out = keep if out is None else out & keep
    return out


def compare(prog: dict, ref: dict) -> Tuple[Dict[str, float], dict]:
    """The check's numbers, and what they were taken over (each step's
    loss gap, each leaf's worst gap) for the run's log; ``prog`` and
    ``ref`` hold ``losses`` (a step each), ``grad`` and ``change`` (a
    client each: norms by leaf) and ``round`` (the program: a replica
    each; the reference: one)."""
    keep = moved(ref)
    detail = {
        "loss_gap": [_gap(p, r, 0.0)
                     for p, r in zip(prog["losses"], ref["losses"])],
        "grad_gap": _worst(_leaf_gaps(p, r)
                           for p, r in zip(prog["grad"], ref["grad"])),
        "change_gap": _worst(_leaf_gaps(p, r, keep)
                             for p, r in zip(prog["change"], ref["change"])),
        "round_gap": _worst(_leaf_gaps(p, ref["round"], keep)
                            for p in prog["round"]),
    }
    numbers = {k: max(v.values() if isinstance(v, dict) else v)
               for k, v in detail.items()}
    detail["grad_probe_gap"] = _worst(
        _probe_gaps(p, r, n) for p, r, n in
        zip(prog["grad_probe"], ref["grad_probe"], ref["grad"]))
    numbers["grad_probe_gap"] = max(detail["grad_probe_gap"].values())
    return numbers, detail


def _probe_gaps(prog: Dict[str, float], ref: Dict[str, float],
                norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between the probes <g, r> (``data.probe``), against
    the reference's norm of that leaf or of the median leaf."""
    floor = statistics.median(norms.values())
    out = {}
    for k in ref:
        p = prog.get(k, math.nan)
        ok = math.isfinite(p) and math.isfinite(ref[k])
        out[k] = (abs(p - ref[k]) / max(norms[k], floor, 1e-30) if ok
                  else math.inf)
    return out


def brief(detail: dict) -> str:
    """``compare``'s detail on one line, three digits a number."""
    def fmt(v):
        if isinstance(v, dict):
            return "{" + ", ".join(f"{k.split('.')[-1]} {x:.3g}"
                                   for k, x in v.items()) + "}"
        return "[" + ", ".join(f"{x:.3g}" for x in v) + "]"
    return "; ".join(f"{k} {fmt(v)}" for k, v in detail.items())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's limits name within its limit."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits {sorted(limits)} name none or other "
                         f"numbers than {NUMBERS}")
    return all(numbers[k] <= limits[k] for k in limits)
