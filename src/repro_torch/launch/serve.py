"""Serving launcher — continuous batching under open-loop synthetic load.

Drives ``repro_torch.serve.ServeEngine`` on random params made from
``--seed``: generate a Poisson/bursty request trace, run the
continuous-batching loop, and print the latency/throughput report (modeled
roofline numbers next to measured host wall-clock).

Examples:
  # on the card (the default device; raises without CUDA)
  python -m repro_torch.launch.serve --arch gemma2-27b

  # the smoke config on the CPU, through the kernels' plain versions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
      --smoke --device cpu

Serving a checkpoint (``--ckpt``) and ``--trace`` / ``--profile`` wait for
their slices (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.core.simulate import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.series import SeriesRegistry
from repro_torch.serve import (
    SchedulerConfig,
    ServeEngine,
    TrafficConfig,
    arrival_summary,
    generate_requests,
)
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="serve fresh random params for this arch")
    ap.add_argument("--smoke", action="store_true")
    # traffic
    ap.add_argument("--process", default="poisson",
                    choices=["poisson", "bursty"])
    ap.add_argument("--rate", type=float, default=None, metavar="RPS",
                    help="offered arrival rate, modeled requests/s "
                         "(default: 0.7 × modeled capacity)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="mean prompt length (geometric)")
    ap.add_argument("--gen", type=int, default=8,
                    help="mean output length (geometric)")
    ap.add_argument("--burst-factor", type=float, default=8.0)
    # scheduler
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--prefills-per-step", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sched = SchedulerConfig(n_slots=args.slots, max_seq_len=args.max_seq_len,
                            max_queue=args.max_queue,
                            max_prefills_per_step=args.prefills_per_step)
    cfg = get_arch(args.arch, smoke=args.smoke)
    params = TF.init_params(cfg, seed=args.seed, device=dev)
    engine = ServeEngine(cfg, params, scheduler=sched)

    # default offered load: 70% of the modeled decode capacity, so the
    # out-of-the-box run sits below the knee of the latency curve
    capacity = sched.n_slots / engine.decode_step_s
    rate = args.rate if args.rate is not None else 0.7 * capacity
    mean_p, mean_g = args.prompt_len, args.gen
    tcfg = TrafficConfig(
        process=args.process, rate_rps=rate, n_requests=args.requests,
        mean_prompt_len=mean_p, max_prompt_len=min(4 * mean_p,
                                                   args.max_seq_len // 2),
        mean_out_len=mean_g, max_out_len=min(4 * mean_g,
                                             args.max_seq_len // 2),
        burst_factor=args.burst_factor, seed=args.seed)
    requests = generate_requests(tcfg, cfg.vocab_size)
    offered = arrival_summary(requests)
    log.info("arch=%s device=%s slots=%d capacity=%.0f tok/s offered=%.0f "
             "rps (%s)", cfg.name, dev, sched.n_slots, capacity,
             offered["rate_rps"], args.process)

    report = engine.run(requests, registry=MetricsRegistry(),
                        series=SeriesRegistry())
    log.info("served %d/%d requests (%d rejected), %d decode steps, "
             "mean occupancy %.2f/%d",
             len(report.completed), len(requests), len(report.rejected),
             report.n_steps, report.mean_occupancy, sched.n_slots)
    log.info("modeled: makespan %.4fs, decode step %.2es, %.0f tok/s | "
             "measured: %.2fs wall, %.0f tok/s",
             report.makespan_s, report.decode_step_s, report.modeled_tok_s,
             report.measured_wall_s, report.measured_tok_s)
    for name, s in report.latency_summary().items():
        log.info("  %-20s p50=%.2e p95=%.2e p99=%.2e (n=%d)", name,
                 s["p50"], s["p95"], s["p99"], s["count"])
    return report


if __name__ == "__main__":
    main()
