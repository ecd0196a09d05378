"""The plain reference of a training cell's first local steps and round.

It follows what the harness reads from the program's set-up: each
client's first ``STEPS`` local steps of plain SGD (momentum 0) at the
stage's first rate on the same batches, from the same weights, and the
dense round that averages the clients after step ``STEPS``. Arithmetic is
float32 with TF32 off; each parameter keeps its stated type, as the
configuration says (bfloat16 weights with float32 moments): an update is
worked out in float32 and the parameter rounded to its type, which is
also what the program's update does.

Readings, the same as the harness takes from the program:

* ``losses``: each step's loss, the mean over the clients;
* ``grad``: each client's first gradient, its 2-norm a leaf;
* ``change``: each client's parameters after ``CHANGE_STEP`` steps less
  the starting weights, a 2-norm a leaf;
* ``round``: the consensus after the round less the starting weights, a
  2-norm a leaf.

The clients run one after another and a layer at a time is recomputed in
the backward, so that a full-width model fits on one card.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from bench import data
from bench.reference import model as M

STEPS = 4          # local steps up to and including the first round's
CHANGE_STEP = 3    # the step after which each client's change is read


def readings(model: dict, traffic: dict, train: dict, seed: int, device,
             mm=torch.matmul) -> dict:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _readings(model, traffic, train, seed, device, mm)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _readings(model, traffic, train, seed, device, mm) -> dict:
    leaves = data.leaf_specs(model)
    p0 = data.make_weights(model, seed, device)
    cdf = data.zipf_cdf(model["vocab_size"],
                        traffic.get("zipf_exponent", 1.0), device)
    batches = [data.make_batch(model, traffic, seed, s, device, cdf)
               for s in range(1, STEPS + 1)]
    eta = train["eta1"]
    C = traffic["clients"]
    losses = [[0.0] * C for _ in range(STEPS)]
    grad: List[Dict[str, float]] = []
    change: List[Dict[str, float]] = []
    grad_probe: List[Dict[str, float]] = []
    finals = []
    for c in range(C):
        p = {k: v.clone() for k, v in p0.items()}
        for step in range(1, STEPS + 1):
            b = batches[step - 1]
            live = {k: v.float().requires_grad_() for k, v in p.items()}
            loss = M.loss(live, model, b["tokens"][c], b["labels"][c],
                          b["frontend"][c] if "frontend" in b else None, mm)
            g = torch.autograd.grad(loss, list(live.values()))
            losses[step - 1][c] = float(loss.detach())
            if step == 1:
                grad.append({k: data.norm(gi) for k, gi in zip(live, g)})
                grad_probe.append({k: data.probe(gi, seed, k)
                                   for k, gi in zip(live, g)})
            with torch.no_grad():
                p = {k: (v.detach() - eta * gi).to(p[k].dtype)
                     for (k, v), gi in zip(live.items(), g)}
            del live, g, loss
            if step == CHANGE_STEP:
                change.append({lf.path: data.diff_norm(p[lf.path],
                                                       p0[lf.path])
                               for lf in leaves})
        finals.append(p)
    consensus = {k: (sum(f[k].float() for f in finals) / C).to(p0[k].dtype)
                 for k in p0}
    rnd = {k: data.diff_norm(consensus[k], p0[k]) for k in p0}
    return {"losses": [sum(l) / C for l in losses], "grad": grad,
            "change": change, "round": rnd,
            "grad_probe": grad_probe}
