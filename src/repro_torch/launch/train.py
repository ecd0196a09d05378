"""Training launcher.

Runs STL-SGD (or a baseline) on an arch with synthetic LM data: the
clients' replicas on one device (``core/local_sgd.py``), stepped and
averaged by ``core/stl_sgd.StagewiseDriver``.

Examples:
  # the smoke config on the CPU, through the kernels' plain versions
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --smoke --device cpu --steps 8

  # on the card (the default device; raises without CUDA)
  python -m repro_torch.launch.train --arch qwen3-14b --layers 2 \\
      --clients 2 --batch 2 --seq 1024 --eta1 0.03 --k1 4 --T1 16 \\
      --stages 2

  # with a Chrome trace of the run's spans, the modeled-vs-measured skew
  # table and a torch.profiler trace, then a serveable checkpoint
  python -m repro_torch.launch.train --arch mamba2-2.7b --smoke \
      --trace /tmp/run.json --profile-dir /tmp/prof --ckpt-out /tmp/ck
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import local_sgd as LS
from repro_torch.core.simulate import resolve_device
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.data.synthetic import make_token_stream
from repro_torch.engine import algorithm_names
from repro_torch.models.attention import _not_ported
from repro_torch.utils.logging import RUN_ID, get_logger
from repro_torch.utils.tree import tree_map

log = get_logger("train")


def synthetic_batches(cfg, n_clients, batch_per_client, seq_len, seed=0,
                      non_iid=False, device=None):
    """Infinite (C, B, S) token/label batches (int64 tensors on
    ``device``, None meaning CUDA) from per-client shards; the reference's
    numpy draws, so both packages see the same tokens."""
    if cfg.frontend:
        raise _not_ported("frontend archs")
    dev = resolve_device(device)
    shards = make_token_stream(200_000, cfg.vocab_size, n_clients, seed=seed,
                               non_iid=non_iid)
    rng = np.random.RandomState(seed)
    n = shards.shape[1] - seq_len - 1
    rows = np.arange(n_clients)[:, None, None]
    offs = np.arange(seq_len)
    while True:
        starts = rng.randint(0, n, size=(n_clients, batch_per_client))
        idx = starts[..., None] + offs
        yield {"tokens": torch.from_numpy(shards[rows, idx]).to(dev,
                                                                torch.long),
               "labels": torch.from_numpy(shards[rows, idx + 1]).to(
                   dev, torch.long)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--algo", default="stl_sc",
                    choices=list(algorithm_names()))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eta1", type=float, default=0.05)
    ap.add_argument("--k1", type=float, default=4)
    ap.add_argument("--T1", type=int, default=32)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--gamma-inv", type=float, default=0.0)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--reducer", default="dense",
                    help="communication reducer: dense | int8 | int<b> | topk")
    ap.add_argument("--topology", default="star",
                    choices=["star", "streaming", "hier"],
                    help="sync round shape: flat star | per-leaf streaming "
                         "| two-level hierarchical (pods of clients)")
    ap.add_argument("--pods", type=int, default=2,
                    help="n_pods for --topology hier (clients split into "
                         "contiguous pods; 1 degenerates to the flat round)")
    ap.add_argument("--inter-reducer", default="int8",
                    help="inter-pod reducer for --topology hier "
                         "(the WAN hop): dense | int8 | int<b> | topk")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-out", default=None, metavar="DIR",
                    help="write the final consensus params with the "
                         "schedule in the checkpoint's meta")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Perfetto-loadable Chrome trace of the "
                         "run's span timeline (plus the comm.*/train.* "
                         "counter tracks) to this path, and a .jsonl span "
                         "log next to it")
    ap.add_argument("--profile", action="store_true",
                    help="wall-time the train/sync steps (synchronised "
                         "with the card) against their modeled prices and "
                         "print the modeled-vs-measured skew table")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also bracket the run in a torch.profiler session "
                         "writing its Chrome trace to DIR (implies "
                         "--profile)")
    ap.add_argument("--profile-calls", type=int, default=None, metavar="N",
                    help="with --profile-dir: trace N step calls after a "
                         "warm-up call instead of the whole run (a "
                         "full-width run's whole trace takes gigabytes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(algo=args.algo, eta1=args.eta1, k1=args.k1, T1=args.T1,
                       n_stages=args.stages, iid=not args.non_iid,
                       gamma_inv=args.gamma_inv, momentum=args.momentum,
                       seed=args.seed, reducer=args.reducer,
                       topology=args.topology, n_pods=args.pods,
                       inter_reducer=args.inter_reducer)
    C = args.clients

    log.info("arch=%s algo=%s clients=%d device=%s", cfg.name, args.algo, C,
             dev)
    state = LS.init_state(args.seed, cfg, C, args.optimizer, device=dev)
    train_fn, sync_fn, _ = LS.build_train_steps(
        cfg, dev, optimizer=args.optimizer, momentum=args.momentum,
        reducer=args.reducer, streaming=args.topology == "streaming")
    if args.topology == "hier":
        # the two-level round: args.reducer intra-pod, compressed inter-pod
        sync_fn = LS.build_sync_step(args.reducer, hierarchical=True,
                                     n_pods=args.pods,
                                     inter_reducer=args.inter_reducer)

    uses_center = args.algo in ("stl_nc1", "stl_nc2") and args.gamma_inv > 0
    if uses_center:
        from repro_torch.core.prox import prox_loss

        pl = prox_loss(lambda p, b: LS.lm_loss(p, cfg, b), args.gamma_inv)

        def train_fn(state, batch, eta, center):
            # a step closing over the stage's center
            tl, _, _ = LS.build_train_steps(
                cfg, dev, optimizer=args.optimizer, momentum=args.momentum,
                loss_fn=lambda p, c, b: pl(p, b, center))
            return tl(state, batch, eta)

    profile = None
    if args.profile or args.profile_dir:
        from repro_torch.obs import ProfileSession
        from repro_torch.serve.engine import DeviceModel

        profile = ProfileSession(logdir=args.profile_dir,
                                 trace_calls=args.profile_calls)
        # one train step = C clients × batch × seq tokens on the roofline
        train_price = DeviceModel().step_time_s(
            cfg, ShapeConfig("train_step", args.seq, C * args.batch,
                             "train"))
        # the sync round is priced from the driver's own topology, which
        # only exists below — resolve the price lazily per call
        sync_price = {"v": 0.0}
        train_fn = profile.wrap(train_fn, "train_step", train_price)
        # wrapping keeps the build_sync_step tags reachable through the
        # __wrapped__ chain, so the driver still prices the tagged round
        sync_fn = profile.wrap(sync_fn, "sync_step",
                               lambda *a, **k: sync_price["v"])

    driver = StagewiseDriver(tcfg, train_fn, sync_fn, uses_center=uses_center)
    if profile is not None:
        template = tree_map(lambda p: p[0], state["params"])
        sync_price["v"] = sum(
            h.time_s for h in driver.build_topology().hop_costs(template, C))
    batches = synthetic_batches(cfg, C, args.batch, args.seq, args.seed,
                                args.non_iid, device=dev)
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(run_id=RUN_ID)
    t0 = time.time()
    if profile is not None:
        with profile:
            ds = driver.run(state, batches, max_iters=args.steps,
                            tracer=tracer)
    else:
        ds = driver.run(state, batches, max_iters=args.steps, tracer=tracer)
    dt = time.time() - t0
    log.info("done: %d iters, %d comm rounds, %.1fs (%.1f it/s)",
             ds.iters_total, ds.rounds_total, dt, ds.iters_total / max(dt, 1e-9))
    for r in ds.results:
        log.info("  stage %d: k=%d rounds=%d loss=%.4f", r.stage, r.k,
                 r.rounds, r.mean_loss)
    if profile is not None:
        from repro_torch.obs import format_skew_table
        profile.emit_spans(tracer)
        print(format_skew_table(profile.skew_table()))
        ds.profile = profile
    if tracer is not None:
        from repro_torch.obs import series as obs_series
        from repro_torch.obs import write_chrome_trace, write_jsonl
        write_chrome_trace(tracer, args.trace,
                           series=obs_series.registry())
        write_jsonl(tracer, args.trace + "l")   # foo.json -> foo.jsonl
        log.info("trace_written", path=args.trace, spans=len(tracer.spans))
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, ds.iters_total, ds.state["params"],
                        {"algo": args.algo, "rounds": ds.rounds_total})
        log.info("checkpoint written to %s", args.ckpt_dir)
    if args.ckpt_out:
        # the consensus params x̄ (the client-axis mean: equal across
        # clients right after a sync round), with the schedule run
        consensus = tree_map(lambda p: torch.mean(p, dim=0),
                             ds.state["params"])
        meta = {
            "arch": args.arch, "smoke": bool(args.smoke),
            # the depth trained (``--layers``): serving rebuilds it
            "n_layers": cfg.n_layers,
            "algo": args.algo, "eta1": args.eta1, "k1": args.k1,
            "T1": args.T1, "n_stages": args.stages,
            "iters": ds.iters_total, "rounds": ds.rounds_total,
            "stages": [{"stage": r.stage, "k": r.k, "rounds": r.rounds,
                        "eta": r.eta, "mean_loss": float(r.mean_loss)}
                       for r in ds.results],
        }
        path = save_checkpoint(args.ckpt_out, ds.iters_total, consensus,
                               meta)
        log.info("serveable checkpoint written to %s", path)
    return ds


if __name__ == "__main__":
    main()
