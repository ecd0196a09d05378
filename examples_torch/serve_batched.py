"""Continuous-batching serving example: ServeEngine under open-loop load.

Serves the gemma2-family smoke model (sliding-window + global alternating
attention, logit softcaps) through ``repro_torch.serve``: Poisson arrivals
join a fixed pool of KV-cache slots at decode-step boundaries and retire
without draining the batch; every multi-token prefill runs the flash
attention kernel on the card. Each slot's token stream equals running
that request alone through ``core.serving.greedy_decode`` — the example
checks one request against it at the end. The arrival rate is half the
capacity modeled by the engine's H100 ``DeviceModel``.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core.serving import greedy_decode
from repro_torch.core.simulate import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve import (SchedulerConfig, ServeEngine, TrafficConfig,
                               generate_requests)

ARCH, N_SLOTS, MAX_SEQ_LEN = "gemma2-27b", 4, 96
TRAFFIC = dict(process="poisson", n_requests=12, mean_prompt_len=16,
               max_prompt_len=32, mean_out_len=8, max_out_len=16, seed=0)


def model(device):
    """The smoke config and its random params (seed 0) on ``device``."""
    cfg = get_arch(ARCH, smoke=True)
    return cfg, TF.init_params(cfg, seed=0, device=device)


def serve(cfg, params, device_model=None):
    """Serve Poisson traffic at half the modeled capacity ÷ 24 requests a
    second through ``ServeEngine`` (``device_model``: the engine's
    pricing, default the H100's). Returns (engine, requests, report)."""
    sched = SchedulerConfig(n_slots=N_SLOTS, max_seq_len=MAX_SEQ_LEN)
    engine = ServeEngine(cfg, params, scheduler=sched, device=device_model)
    capacity = sched.n_slots / engine.decode_step_s
    print(f"{cfg.name}: {sched.n_slots} slots, modeled decode step "
          f"{engine.decode_step_s:.2e}s ({capacity:.0f} tok/s modeled "
          f"capacity; window ring-buffers hold {cfg.attention.window} "
          f"slots)")
    tcfg = TrafficConfig(rate_rps=0.5 * capacity / 24, **TRAFFIC)
    requests = generate_requests(tcfg, cfg.vocab_size)
    report = engine.run(requests)

    print(f"served {len(report.completed)}/{len(requests)} requests in "
          f"{report.n_steps} decode steps "
          f"(mean occupancy {report.mean_occupancy:.2f}/{sched.n_slots})")
    print(f"modeled {report.modeled_tok_s:.0f} tok/s over "
          f"{report.makespan_s:.2e}s makespan | measured "
          f"{report.measured_tok_s:.0f} tok/s over "
          f"{report.measured_wall_s:.2f}s host wall")
    for name, s in report.latency_summary().items():
        print(f"  {name:22s} p50={s['p50']:.2e} p95={s['p95']:.2e} "
              f"p99={s['p99']:.2e}")
    print("generations (first 8 ids each):")
    for rec in report.records[:4]:
        print(f"  req{rec.id} (slot {rec.slot}): {rec.tokens[:8]}")
    return engine, requests, report


def check_request0(cfg, params, requests, report):
    """Continuous batching never changes what one request decodes to:
    request 0's tokens equal ``greedy_decode`` on the same params."""
    rec, req = report.records[0], requests[0]
    prompt = torch.from_numpy(req.prompt[None, :]).to(
        params["embed"].device, torch.long)
    ref, _ = greedy_decode(params, cfg, prompt, req.n_out, MAX_SEQ_LEN)
    assert rec.tokens == ref[0].tolist(), "batching changed tokens"
    print("req0 equal to per-request greedy_decode ✓")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg, params = model(device)
    engine, requests, report = serve(cfg, params)
    check_request0(cfg, params, requests, report)
    return report


if __name__ == "__main__":
    main()
