"""Hierarchical pod topology — dense intra-pod + int8 inter-pod rounds.

8 clients in 2 pods of 4. Every communication round first averages
parameters *inside* each pod over the fast link (dense — the link is
cheap), then runs a compressed (int8 error-feedback) round *between* pods
over the slow WAN. The engine's ``Hierarchical`` topology composes the two
``repro_torch.comm`` reducers and prices each hop with its own α–β
``NetworkModel``: the intra-pod hop with the fast-link preset of
``comm/cost.py::link_model`` (a modeling constant shared with the JAX
package, not a measurement of any link), the WAN at the TrainConfig
default (5 ms, 1 Gbit/s).

The run compares flat-dense / flat-int8 / hierarchical on the same
STL-SGD^sc schedule and prints the per-hop modeled comm time for each,
then executes the same hierarchical config through ``StagewiseDriver``,
whose sync step runs the real two-level round
(``build_sync_step(hierarchical=True)``) — the int8 hop through the
quantize and dequant_mean kernels on the card — and asserts that the
driver's executed byte ledger equals the modeled ``Hierarchical`` tree
totals exactly.

    PYTHONPATH=src python examples_torch/hierarchical_pods.py \\
        [--driver] [--device cpu]

``--driver`` skips the (slower) simulator comparison and runs only the
driver section.
"""
import argparse
import itertools

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import local_sgd as LS
from repro_torch.core import simulate
from repro_torch.core.stl_sgd import (StagewiseDriver, driver_state,
                                      make_client_sgd_step)
from repro_torch.data import make_binary_classification, partition_iid
from repro_torch.engine import topology_for
from repro_torch.models import logreg
from repro_torch.utils.tree import tree_map

N_CLIENTS, N_PODS, N, D, LAM = 8, 2, 4096, 64, 1e-3
GD_STEPS, GD_LR, EVAL_EVERY = 4000, 2.0, 8
CONFIGS = [
    ("flat dense", dict(topology="star", reducer="dense")),
    ("flat int8", dict(topology="star", reducer="int8")),
    ("hier dense+int8", dict(topology="hier", reducer="dense",
                             inter_reducer="int8", n_pods=N_PODS)),
]
SIM_SCHEDULE = dict(algo="stl_sc", eta1=0.5, T1=256, k1=8.0, n_stages=8)
DRIVER_SCHEDULE = dict(algo="stl_sc", eta1=0.5, T1=64, k1=8.0, n_stages=4)


def problem(device):
    """Logistic regression on ``device``: the loss, the full objective,
    the start point and the clients' IID shards."""
    x, y = make_binary_classification(n=N, d=D, seed=0)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in partition_iid(x, y, N_CLIENTS).items()}
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    return {"loss_fn": lambda p, b: logreg.loss_fn(p, b, LAM),
            "eval_fn": lambda p: logreg.full_objective(p, xt, yt, LAM),
            "p0": logreg.init_params(D, device=device), "data": data}


def optimum(prob, steps=GD_STEPS):
    """Near-exact f* for the gap: full-batch gradient descent in float32."""
    grad = torch.func.grad(prob["eval_fn"])
    p = prob["p0"]
    for _ in range(steps):
        g = grad(p)
        p = {k: p[k] - GD_LR * g[k] for k in p}
    return float(prob["eval_fn"](p))


def compare(prob, fstar, configs=CONFIGS, schedule=SIM_SCHEDULE, *, device,
            rng=None):
    """Each topology through ``simulate.run`` with its per-hop summary:
    prints and returns ``{name: (history, summary)}``."""
    out = {}
    n_clients = prob["data"]["y"].shape[0]
    for name, kw in configs:
        cfg = TrainConfig(**schedule, iid=True, batch_per_client=32, seed=0,
                          **kw)
        hist = simulate.run(prob["loss_fn"], prob["p0"], prob["data"], cfg,
                            prob["eval_fn"], device=device,
                            eval_every=EVAL_EVERY, rng=rng)
        summ = topology_for(cfg).summary(prob["p0"], n_clients,
                                         hist[-1].round)
        print(f"{name:16s} rounds={summ['rounds']:4d} "
              f"bytes={summ['total_bytes']:9d} "
              f"modeled_comm={summ['total_time_s']:7.3f}s "
              f"final_gap={hist[-1].value - fstar:.2e}")
        for hop in summ["hops"]:
            print(f"  └ {hop['hop']:10s} [{hop['reducer']:5s}] "
                  f"bytes/round={hop['bytes_per_round']:6d} "
                  f"hop_time={hop['total_time_s']:.4f}s")
        out[name] = (hist, summ)
    print("\nThe hierarchical round keeps the dense average where bandwidth")
    print("is free (intra-pod) and compresses only the WAN hop —")
    print("composing the paper's axis (fewer rounds via stagewise k_s) with")
    print("cheaper rounds on the links that actually cost something.")
    return out


def driver(prob, fstar, schedule=DRIVER_SCHEDULE, *, device, rng=None,
           sync_rng=None):
    """The same two-level round executed by ``StagewiseDriver``; asserts
    the executed byte ledger against the modeled tree totals. ``rng``
    keys the minibatch draws, ``sync_rng`` the int8 hop's bits. Returns
    ``(driver state, consensus gap)``."""
    n_clients = prob["data"]["y"].shape[0]
    print("\n--- StagewiseDriver, topology=hier (2-level sync round) ---")
    dcfg = TrainConfig(**schedule, iid=True, batch_per_client=32, seed=0,
                       topology="hier", reducer="dense",
                       inter_reducer="int8", n_pods=N_PODS)
    train_step = make_client_sgd_step(prob["loss_fn"], prob["data"],
                                      batch=32, rng=rng)
    sync_step = LS.build_sync_step("dense", hierarchical=True, n_pods=N_PODS,
                                   inter_reducer="int8", rng=sync_rng)
    drv = StagewiseDriver(dcfg, train_step, sync_step)
    ds = drv.run(driver_state(prob["p0"], n_clients),
                 itertools.repeat(None))   # train_step samples via rng

    consensus = tree_map(lambda x: x[0], ds.state["params"])
    gap = float(prob["eval_fn"](consensus)) - fstar
    modeled = (topology_for(dcfg).round_bytes(prob["p0"], n_clients)
               * ds.rounds_total)
    print(f"driver hier     rounds={ds.rounds_total:4d} "
          f"bytes={ds.comm_bytes_total:9d} "
          f"modeled_comm={ds.comm_time_s:7.3f}s final_gap={gap:.2e}")
    for leaf in ds.leaf_ledger:
        print(f"  └ {leaf['hop']:10s} leaf {leaf['path']:9s} "
              f"bytes={leaf['bytes']:8d} time={leaf['time_s']:.4f}s")
    assert ds.comm_bytes_total == modeled, (ds.comm_bytes_total, modeled)
    assert sum(leaf["bytes"] for leaf in ds.leaf_ledger) == \
        ds.comm_bytes_total
    print("\nmodeled-vs-executed byte agreement: OK "
          f"({ds.comm_bytes_total} bytes over {ds.rounds_total} two-level "
          "rounds; ledger == Hierarchical tree totals exactly)")
    return ds, gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--driver", action="store_true",
                    help="run only the StagewiseDriver section")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    device = simulate.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = problem(device)
    fstar = optimum(prob)
    print(f"f* = {fstar:.6f}; STL-SGD^sc, {N_CLIENTS} clients"
          f" ({N_PODS} pods of {N_CLIENTS // N_PODS})\n")
    out = {} if args.driver else compare(prob, fstar, device=device)
    out["driver"] = driver(prob, fstar, device=device)
    return out


if __name__ == "__main__":
    main()
