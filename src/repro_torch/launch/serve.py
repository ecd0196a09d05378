"""Serving launcher — continuous batching under open-loop synthetic load.

Drives ``repro_torch.serve.ServeEngine``: restore a checkpoint (either
package's ``launch/train.py --ckpt-out``) or make random params from
``--seed``, generate a Poisson/bursty request trace, run the
continuous-batching loop, and print the latency/throughput report (modeled
roofline numbers next to measured host wall-clock).

Examples:
  # on the card (the default device; raises without CUDA)
  python -m repro_torch.launch.serve --arch gemma2-27b
  python -m repro_torch.launch.serve --arch mamba2-2.7b
  python -m repro_torch.launch.serve --arch gemma3-12b

  # the smoke config on the CPU, through the kernels' plain versions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
      --smoke --device cpu

  # serve a trained checkpoint (the arch comes from its meta), with a
  # Chrome trace and the modeled-vs-measured skew table
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --smoke --device cpu --steps 8 --ckpt-out /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt /tmp/ck \\
      --device cpu --trace /tmp/serve_trace.json --profile
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.core.simulate import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.obs import write_chrome_trace, write_jsonl
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.series import SeriesRegistry
from repro_torch.serve import (
    SchedulerConfig,
    ServeEngine,
    TrafficConfig,
    arrival_summary,
    generate_requests,
)
from repro_torch.utils.logging import RUN_ID, get_logger

log = get_logger("serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", metavar="DIR",
                     help="checkpoint dir from launch/train.py --ckpt-out "
                          "(arch is read from checkpoint meta)")
    src.add_argument("--arch", help="serve fresh random params for this arch")
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
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export the request/decode span timeline plus the "
                         "serve.* counter tracks (queue depth, batch "
                         "occupancy, tokens/s) as a Perfetto-loadable "
                         "Chrome trace (+ .jsonl log)")
    ap.add_argument("--profile", action="store_true",
                    help="wall-time the prefill/decode steps (synchronised "
                         "with the card) against the roofline prices and "
                         "print the modeled-vs-measured skew table")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also bracket the run in a torch.profiler session "
                         "writing its Chrome trace to DIR (implies "
                         "--profile)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sched = SchedulerConfig(n_slots=args.slots, max_seq_len=args.max_seq_len,
                            max_queue=args.max_queue,
                            max_prefills_per_step=args.prefills_per_step)
    if args.ckpt:
        engine = ServeEngine.from_checkpoint(args.ckpt, torch_device=dev,
                                             scheduler=sched)
        cfg = engine.cfg
    else:
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

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(run_id=RUN_ID)
    registry = MetricsRegistry()
    series = SeriesRegistry()
    profile = None
    if args.profile or args.profile_dir:
        from repro_torch.obs import ProfileSession
        profile = ProfileSession(logdir=args.profile_dir)
    if profile is not None:
        with profile:
            report = engine.run(requests, tracer=tracer, registry=registry,
                                series=series, profile=profile)
    else:
        report = engine.run(requests, tracer=tracer, registry=registry,
                            series=series)
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
    if profile is not None:
        from repro_torch.obs import format_skew_table
        profile.emit_spans(tracer)
        print(format_skew_table(profile.skew_table()))
        report.profile = profile
    if tracer is not None:
        write_chrome_trace(tracer, args.trace, series=series)
        write_jsonl(tracer, args.trace + "l")   # foo.json -> foo.jsonl
        log.info("trace_written", path=args.trace, spans=len(tracer.spans))
    return report


if __name__ == "__main__":
    main()
