"""Federated Non-IID training — the paper's §5.1 Non-IID protocol end-to-end.

Builds the label-sorted Non-IID partition (s=50% as in the paper), measures
the client gradient diversity ζ, derives the admissible k₁ from Theorem 1's
formula, and runs STL-SGD^sc with the √2 Non-IID stage growth vs Local SGD.
Then composes the stagewise schedule with ``repro_torch.comm`` compressed
rounds (int8 / top-k error-feedback reducers; int8 through the quantize
and dequant_mean kernels on the card) and prices each run with the α–β
network cost model — rounds × bytes × modeled seconds in one table.
Then re-runs the Non-IID protocol on the discrete-event runtime
(``repro_torch.runtime``) with a straggler cohort, sync barriers vs
AsyncPeriod merge-on-arrival, priced in modeled wall-clock — and, on a
multi-leaf MLP, blocking vs streaming per-leaf uploads: leaf l's upload
starts as its last local step completes, overlapping the remaining
backward compute, with the trajectory bit-exact across schedules.

    PYTHONPATH=src python examples_torch/federated_noniid.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch import runtime
from repro_torch.comm import comm_summary_for
from repro_torch.configs.base import TrainConfig
from repro_torch.core import schedules, simulate
from repro_torch.data import make_binary_classification
from repro_torch.data.partition import gradient_diversity, partition_paper
from repro_torch.models import logreg, mlp

N, N_SAMPLES, D, LAM = 8, 8192, 64, 1e-3
ETA1, L = 0.5, 0.5   # Theorem 1's L≈0.25 for logistic features ~1, + λ
GD_STEPS, GD_LR = 4000, 2.0
TARGET, EVAL_EVERY, MAX_ROUNDS = 1e-4, 8, 12000
ALGOS = [
    ("sync", dict(k1=1.0, n_stages=24)),
    ("local", dict(k1=8.0, n_stages=24)),
    ("stl_sc", dict(k1=8.0, n_stages=14)),   # Non-IID: k_{s+1} = √2·k_s
]
REDUCERS = ("dense", "int8", "topk")
REDUCER_SCHEDULE = dict(algo="stl_sc", eta1=ETA1, T1=512, k1=8.0,
                        n_stages=14)
# 2 of 8 clients run 4× slower: sync rounds barrier on them every round;
# AsyncPeriod merges each upload on arrival with staleness-decayed weights
STRAGGLER_RUNS = [("local", dict(k1=8.0, T1=2048, n_stages=2)),
                  ("stl_sc", dict(k1=8.0, T1=512, n_stages=5))]
STRAGGLERS = dict(straggler_frac=0.25, straggler_slowdown=4.0,
                  base_step_time_s=1e-3)
STREAM_CFG = TrainConfig(algo="sync", eta1=0.1, T1=64, n_stages=2, iid=False,
                         batch_per_client=32, seed=0,
                         comm_latency_s=1e-4, comm_bandwidth_gbps=0.45,
                         **STRAGGLERS)


def problem(device):
    """The Non-IID logistic regression problem on ``device``: the loss,
    the full objective, the start point, the clients' shards (s = 50%)
    and the whole dataset."""
    x, y = make_binary_classification(n=N_SAMPLES, d=D, seed=0)
    data = {k: torch.from_numpy(v).to(device) for k, v in
            partition_paper(x, y, N, iid_percent=50.0, seed=1).items()}
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    return {"loss_fn": lambda p, b: logreg.loss_fn(p, b, LAM),
            "eval_fn": lambda p: logreg.full_objective(p, xt, yt, LAM),
            "p0": logreg.init_params(D, device=device), "data": data,
            "x": xt, "y": yt}


def heterogeneity(prob):
    """ζ at x0 and Theorem 1's admissible k₁ for ζ = 0 and the measured ζ."""
    n_clients = prob["data"]["y"].shape[0]
    zeta = float(gradient_diversity(
        prob["data"], torch.func.grad(prob["loss_fn"], argnums=0),
        prob["p0"]))
    print(f"gradient diversity ζ at x0: {zeta:.4f}")
    k1_hom = schedules.theory_k1(ETA1, L, n_clients, sigma=1.0, zeta=0.0,
                                 iid=False)
    k1_non = schedules.theory_k1(ETA1, L, n_clients, sigma=1.0, zeta=zeta,
                                 iid=False)
    print(f"theory k1 (Non-IID formula): ζ=0 → {k1_hom:.2f}, measured ζ → "
          f"{k1_non:.2f} (heterogeneity shrinks the admissible period)")
    return zeta, k1_hom, k1_non


def optimum(prob, steps=GD_STEPS):
    """Near-exact f* for the gap: full-batch gradient descent in float32."""
    grad = torch.func.grad(prob["eval_fn"])
    p = prob["p0"]
    for _ in range(steps):
        g = grad(p)
        p = {k: p[k] - GD_LR * g[k] for k in p}
    return float(prob["eval_fn"](p))


def compare(prob, fstar, algos=ALGOS, max_rounds=MAX_ROUNDS, *, device,
            rng=None):
    """Each algorithm on the Non-IID shards to gap < ``TARGET``: prints
    and returns ``{algo: (history, rounds to target)}``."""
    out = {}
    for algo, kw in algos:
        cfg = TrainConfig(algo=algo, eta1=ETA1, T1=512, iid=False,
                          batch_per_client=32, seed=0, **kw)
        hist = simulate.run(prob["loss_fn"], prob["p0"], prob["data"], cfg,
                            prob["eval_fn"], device=device,
                            eval_every=EVAL_EVERY, max_rounds=max_rounds,
                            target=fstar + TARGET, rng=rng,
                            lr_alpha=1e-3 if algo in ("sync", "local")
                            else 0.0)
        r = simulate.rounds_to_target(hist, fstar + TARGET)
        print(f"{algo:8s} Non-IID rounds to gap<{TARGET}: {r} "
              f"(final gap {hist[-1].value - fstar:.2e})")
        out[algo] = (hist, r)
    return out


def reducers(prob, fstar, names=REDUCERS, schedule=REDUCER_SCHEDULE, *,
             device, rng=None):
    """Fewer rounds (stagewise k_s) × cheaper rounds (compressed reducer):
    STL-SGD^sc with each reducer, priced by the α–β model (5 ms latency,
    1 Gbit/s — the TrainConfig comm_* defaults). Returns
    ``{reducer: (history, comm summary)}``."""
    out = {}
    n_clients = prob["data"]["y"].shape[0]
    print("\nreducer   rounds  bytes      modeled_s  final_gap")
    for red in names:
        cfg = TrainConfig(**schedule, iid=False, batch_per_client=32,
                          seed=0, reducer=red)
        hist = simulate.run(prob["loss_fn"], prob["p0"], prob["data"], cfg,
                            prob["eval_fn"], device=device,
                            eval_every=EVAL_EVERY, max_rounds=MAX_ROUNDS,
                            target=fstar + TARGET, rng=rng)
        summ = comm_summary_for(cfg, prob["p0"], n_clients, hist[-1].round)
        print(f"{summ['reducer']:9s} {summ['rounds']:6d}  "
              f"{summ['total_bytes']:9d}  {summ['total_time_s']:8.3f}s  "
              f"{hist[-1].value - fstar:.2e}")
        out[red] = (hist, summ)
    return out


def stragglers(prob, fstar, runs=STRAGGLER_RUNS, max_rounds=None, *, device,
               rng=None):
    """The same problem on the event runtime with a straggler cohort,
    sync barriers against merge-on-arrival, in modeled wall-clock
    seconds. Returns ``{(algo, mode): RuntimeResult}``."""
    out = {}
    print("\nalgo      mode   merges  modeled_s  final_gap")
    for algo, kw in runs:
        for mode in ("sync", "async"):
            cfg = TrainConfig(algo=algo, eta1=ETA1, iid=False,
                              batch_per_client=32, seed=0,
                              async_mode=mode == "async", **STRAGGLERS, **kw)
            res = runtime.run(prob["loss_fn"], prob["p0"], prob["data"], cfg,
                              prob["eval_fn"], device=device,
                              eval_every=64, max_rounds=max_rounds,
                              rng=rng)
            print(f"{algo:9s} {mode:6s} {res.rounds:6d}  "
                  f"{res.wall_clock_s:8.3f}s  "
                  f"{res.history[-1].value - fstar:.2e}")
            out[algo, mode] = res
    return out


def streaming(prob, mlp_p0, cfg=STREAM_CFG, *, device, rng=None):
    """The 8-leaf MLP on the same features and stragglers, blocking
    against streaming per-leaf uploads: each leaf's upload starts as soon
    as its last local step completes (reverse-layer order). Pure clock
    accounting — the parameters are bit-exact across schedules; only the
    modeled wall-clock moves. Returns ``{schedule: RuntimeResult}``."""
    print("\nschedule   rounds  modeled_s  final_obj   (8-leaf MLP, 4x "
          "stragglers)")
    out = {}
    for sched in ("blocking", "streaming"):
        res = runtime.run(
            lambda p, b: mlp.loss_fn(p, b, LAM), mlp_p0, prob["data"],
            dataclasses.replace(cfg, upload_schedule=sched),
            lambda p: mlp.full_objective(p, prob["x"], prob["y"], LAM),
            device=device, eval_every=32, rng=rng)
        out[sched] = res
        print(f"{sched:9s} {res.rounds:7d}  {res.wall_clock_s:8.3f}s  "
              f"{res.history[-1].value:.6f}")
    speed = out["blocking"].wall_clock_s / out["streaming"].wall_clock_s
    same = out["blocking"].history[-1].value == \
        out["streaming"].history[-1].value
    print(f"streaming overlap: {speed:.2f}x modeled wall-clock win, "
          f"objective bit-exact: {same}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    device = simulate.resolve_device(ap.parse_args(argv).device)
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = problem(device)
    out = {"heterogeneity": heterogeneity(prob)}
    fstar = optimum(prob)
    out["compare"] = compare(prob, fstar, device=device)
    out["reducers"] = reducers(prob, fstar, device=device)
    out["stragglers"] = stragglers(prob, fstar, device=device)
    out["streaming"] = streaming(prob, mlp.init_params(D, seed=42,
                                                       device=device),
                                 device=device)
    return out


if __name__ == "__main__":
    main()
