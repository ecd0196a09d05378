#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``), on ``cuda:0``, in phases; any
failure propagates, so the script exits non-zero and prints no result.

  1. Environment: torch / CUDA versions and the card's name and power
     limit (``nvidia-smi``).
  2. Build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel) and loads them.
  3. Kernels against their plain PyTorch versions on the card, at the
     slice's shapes — the logreg leaf (32, 784), the MLP's leaves — and at
     one large shape, (32, 2^20), where the memory bound shows: int8 and
     int4 codes exactly equal, the fused update to 1e-6 (float32) and
     1e-2 (bfloat16), dequant_mean to 1e-6. Each kernel is timed with CUDA
     events (median of 25 single launches) beside its bound (bytes it
     must move over 3.35 TB/s, or its float32 operations over 67 TFLOP/s,
     whichever is larger), the plain version's time and, for the fused
     update, the time of the one PyTorch call that computes the same
     function (``torch._fused_sgd_``, the op behind
     ``torch.optim.SGD(fused=True)``), held to the plain version first.
  4. The slice: the port against itself on a small input (the card's run
     against the CPU run on the same draws), then ``stl_sc`` + int8 at
     the full width of the paper's Table 1 convex model (logreg, d=784,
     n=11,791, N=32, B=32, η₁=0.5, T₁=512, k₁=16, IID) and on the MLP
     (width 96, depth 3, 8 leaves) over the streaming topology, each cut
     to 3 of its 11 stages (96 rounds, 3,584 local steps). The objective
     must be finite and fall below 0.9× its start, the comm ledger must
     equal the integer formula, and every kernel's launch count (reset to
     0 just before each run) must have gone up.
  5. Flash attention against its plain version on the card at gemma2-27b's
     layer shapes, q (1, 4608, 32, 128) and k/v (1, 4608, 16, 128) in
     bfloat16 — local (window 4096, softcap 50), global (causal, softcap
     50), causal without softcap — plus a ragged Sq = Sk = 1000 shape and a
     small float32 shape. bf16 is held to ``ref.py``'s tolerance
     (elementwise 5e-3 absolute plus 1e-2 relative, and each query row of
     each head to 1e-2 of its norm), float32 to 1e-5 absolute plus as much
     relative; timed like phase 3, bound by its operations
     (4·B·H·D·pairs over 989 TFLOP/s bf16, 67 TFLOP/s float32) or bytes,
     and at the causal shape beside ``scaled_dot_product_attention``
     (held to the plain version first; the port never calls it).
  6. Serving, small: the card's run of gemma2-27b's SMOKE config (2 layers
     L+G, window 64, float32) against the CPU run on the same weights, one
     80-token prompt through ``prefill`` and 8 decode steps.
  7. Serving at full width: gemma2-27b FULL (46 layers, d_model 4608,
     vocab 256000, bfloat16, random weights from seed 0) behind
     ``ServeEngine`` with 4 slots of 6,144 tokens, 6 Poisson requests plus
     one 4,608-token prompt (the window bites in prefill, the local ring
     wraps in decode). Every request must complete, flash attention must
     launch 46 times per prefill, and the tokens must match the port's
     ``greedy_decode`` (first token exactly; later ones up to the first
     near-tie). Prints wall, tok/s, prefill and decode-step times, peak
     memory and a profile of one prefill and 4 decode steps.
  8. One ``{"kernels": [...]}`` summary line, then the last line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32, outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 dense, tensor cores
TRAIN_KERNELS = ("fused_sgd_update", "quantize_kernel", "dequant_mean_kernel")
# A greedy pick whose top-2 logit gap is under this may flip between the
# engine's 4-slot decode and the single-request reference: their bfloat16
# products round differently, which moves a logit of magnitude 4-8 by a
# few of its bfloat16 steps (2^-5 there), so 8 steps' worth is the cut.
MARGIN_TOL = 0.25
N_CLIENTS = 32
SLICE_TOPOLOGY = {"logreg": "star", "mlp": "streaming"}
TIMING_REPS = 25
SLEEP_CYCLES = 10_000_000   # ~5 ms at the H100's ~2 GHz SM clock


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    """Median time of one call as the caller sees it on the card: CUDA
    events around each single call, so the wrapper's host-side work shows
    as device idle time (a launch-bound call is measured as such)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def device_ms(torch, fn, batch: int = 10, reps: int = TIMING_REPS) -> float:
    """Median device time of one call: TIMING_REPS samples, each a batch
    of calls queued behind a sleeping kernel so they run back to back on
    the device, CUDA events around the batch, divided by its size."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)   # holds the stream while we queue
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / batch)
    return statistics.median(samples)


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = F32_FLOPS):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def sgd_library(p, m, g, *, eta, beta, wd=0.0):
    """The one PyTorch call computing the fused update (the op behind
    ``torch.optim.SGD(fused=True)``), in place on p and m; timed beside the
    kernel, used nowhere in the port."""
    import torch
    torch._fused_sgd_([p], [g], [m], weight_decay=wd, momentum=beta, lr=eta,
                      dampening=0.0, nesterov=False, maximize=False,
                      is_first_step=False)


def check_kernels(torch, shapes):
    """Phase 3: each kernel against its plain version, and its times."""
    from repro_torch.kernels.fused_update.kernel import fused_sgd_update
    from repro_torch.kernels.fused_update.ref import sgd_update_ref
    from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                    quantize_kernel)
    from repro_torch.kernels.quantize.ops import compute_scale
    from repro_torch.kernels.quantize.ref import (dequant_mean_ref,
                                                 quantize_ref)

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for label, (N, M) in shapes.items():
        n = N * M
        p = torch.randn((N, M), generator=g, device=dev)
        m = torch.randn((N, M), generator=g, device=dev)
        gr = torch.randn((N, M), generator=g, device=dev)
        err_f = 0.0
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
            pk, mk, gk = p.to(dt), m.clone(), gr.to(dt)
            pr, mr = sgd_update_ref(pk, mk, gk, eta=0.05, beta=0.9, wd=1e-4)
            fused_sgd_update(pk, mk, gk, eta=0.05, beta=0.9, wd=1e-4)
            torch.cuda.synchronize()
            e = 0.0
            for got, ref in ((pk, pr), (mk, mr)):
                diff = (got.float() - ref.float()).abs()
                if not bool((diff <= tol + tol * ref.float().abs()).all()):
                    raise AssertionError(f"fused_sgd_update {label} {dt}: "
                                         f"max err {float(diff.max())}")
                e = max(e, float(diff.max()))
            if dt == torch.float32:
                err_f = e
        # the library call timed beside the kernel must compute the same
        # function: torch.optim.SGD(fused=True)'s op, dampening 0, no Nesterov
        pl, ml = p.clone(), m.clone()
        sgd_library(pl, ml, gr, eta=0.05, beta=0.9, wd=1e-4)
        pr, mr = sgd_update_ref(p, m, gr, eta=0.05, beta=0.9, wd=1e-4)
        torch.cuda.synchronize()
        lib_err = max(float((a - b).abs().max())
                      for a, b in ((pl, pr), (ml, mr)))
        if not lib_err <= 1e-5:
            raise AssertionError(f"torch._fused_sgd_ {label}: "
                                 f"max err {lib_err}")
        y = torch.randn((N, M), generator=g, device=dev) \
            * torch.rand((N, 1), generator=g, device=dev)
        rb = torch.randint(-2 ** 31, 2 ** 31, (N, M), dtype=torch.int32,
                           generator=g, device=dev)
        s = compute_scale(y, dim=1)
        err_d = 0.0
        for bits in (8, 4):
            q = quantize_kernel(y, rb, s, bits=bits)
            qr = quantize_ref(y, rb, s[:, None], bits=bits)
            torch.cuda.synchronize()
            if not torch.equal(q, qr):
                raise AssertionError(
                    f"quantize {label} int{bits}: "
                    f"{int((q != qr).sum())} codes differ")
            mean = dequant_mean_kernel(q, s, bits=bits)
            mr = dequant_mean_ref(q, s, bits=bits)
            torch.cuda.synchronize()
            e = float((mean - mr).abs().max())
            if not e <= 1e-6:
                raise AssertionError(f"dequant_mean {label} int{bits}: "
                                     f"max err {e}")
            err_d = max(err_d, e)

        # times: float32 update, int8 codes, at this shape
        pk, mk = p.clone(), m.clone()
        q = quantize_kernel(y, rb, s, bits=8)
        fns = {
            "fused_sgd_update": (
                lambda: fused_sgd_update(pk, mk, gr, eta=1e-6, beta=0.9),
                lambda: sgd_update_ref(p, m, gr, eta=1e-6, beta=0.9),
                lambda: sgd_library(pl, ml, gr, eta=1e-6, beta=0.9),
                bound_ms(20 * n, 4 * n), err_f),
            "quantize_kernel": (
                lambda: quantize_kernel(y, rb, s, bits=8),
                lambda: quantize_ref(y, rb, s[:, None], bits=8),
                None, bound_ms(9 * n + 4 * N, 6 * n), 0.0),
            "dequant_mean_kernel": (
                lambda: dequant_mean_kernel(q, s, bits=8),
                lambda: dequant_mean_ref(q, s, bits=8),
                None, bound_ms(n + 4 * N + 4 * M, 2 * n + N), err_d),
        }
        for name, (kf, pf, lf, (bms, by), err) in fns.items():
            ms, plain, call = (device_ms(torch, kf), device_ms(torch, pf),
                               call_ms(torch, kf))
            lib = device_ms(torch, lf) if lf is not None else None
            rows[(name, label)] = {"ms": ms, "plain_ms": plain,
                                   "call_ms": call, "library_ms": lib,
                                   "bound_ms": bms, "bound_by": by,
                                   "max_abs_err": err}
            lib_txt = "-" if lib is None else f"{lib * 1e3:.2f} us"
            log(f"[kernels] {name:20s} {label:13s} ({N}, {M}): device "
                f"{ms * 1e3:8.2f} us, plain {plain * 1e3:8.2f} us, library "
                f"{lib_txt}, bound {bms * 1e3:8.3f} us ({by}); one call "
                f"{call * 1e3:7.2f} us; max_abs_err {err:.3g}")
    return rows


class HostKey:
    """A key whose draws are made on the CPU and handed to the card, so a
    run on the card and a run on the CPU see the same draws."""

    def __init__(self, key, device):
        self.key, self.device = key, device

    def split(self, n):
        return [HostKey(k, self.device) for k in self.key.split(n)]

    def fold_in(self, data):
        return HostKey(self.key.fold_in(data), self.device)

    def batch_indices(self, n_clients, batch, high):
        return self.key.batch_indices(n_clients, batch, high).to(self.device)

    def bits(self, shape):
        return self.key.bits(shape).to(self.device)


def small_reference_check(torch):
    """The card's run of the slice against the CPU run (plain versions) on
    one small input and the same draws. Tolerances as the CPU parity tests
    state them: 1e-5 dense (summation order), 1e-4 int8 (a code may flip
    at a floor() boundary)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp
    from repro_torch.utils.rng import TorchKey

    x, y = make_binary_classification(n=256, d=32, seed=0)
    data = partition_iid(x, y, 4, seed=1)
    p0 = mlp.init_params(32, width=16, depth=3, seed=1)
    for reducer, tol in (("dense", 1e-5), ("int8", 1e-4)):
        cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=16, k1=4.0, n_stages=2,
                          batch_per_client=8, reducer=reducer,
                          topology="streaming")
        hist = {}
        for dev in ("cpu", "cuda"):
            xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
            hist[dev] = [r.value for r in simulate.run(
                lambda p, b: mlp.loss_fn(p, b, 1e-3), p0,
                {k: torch.from_numpy(v) for k, v in data.items()}, cfg,
                lambda p: mlp.full_objective(p, xt, yt, 1e-3), device=dev,
                rng=HostKey(TorchKey(0), torch.device(dev)))]
        err = max(abs(a - b) for a, b in zip(hist["cpu"], hist["cuda"]))
        log(f"[reference] mlp {reducer}: card vs CPU over "
            f"{len(hist['cpu'])} records, max |diff| {err:.3g} (tol {tol})")
        if not (len(hist["cpu"]) == len(hist["cuda"]) and err <= tol):
            raise AssertionError(f"card run disagrees with the CPU run "
                                 f"({reducer}): {err}")


def make_slice(torch, model: str, x, y, n_stages: int = 3, **backend_kw):
    """The slice's full-width configuration: (engine, backend, params)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import partition_iid
    from repro_torch.engine import Engine
    from repro_torch.models import logreg, mlp

    dev = torch.device("cuda:0")
    n, d = x.shape
    lam = 1.0 / n
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in partition_iid(x, y, N_CLIENTS, seed=1).items()}
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    mod = logreg if model == "logreg" else mlp
    p0 = (logreg.init_params(d, device=dev) if model == "logreg"
          else mlp.init_params(d, width=96, depth=3, seed=0, device=dev))
    cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=512, k1=16.0,
                      n_stages=n_stages, iid=True, batch_per_client=32,
                      reducer="int8", topology=SLICE_TOPOLOGY[model], seed=0)
    engine = Engine(cfg.algo, cfg)
    backend = simulate.VmapSimulatorBackend(
        lambda p, b: mod.loss_fn(p, b, lam), p0, data,
        lambda p: mod.full_objective(p, xt, yt, lam), device=dev,
        **backend_kw)
    return engine, backend, p0


def run_slice(torch, model: str, x, y):
    """Phase 4: one full-width run of the port's main path."""
    from repro_torch import kernels
    from repro_torch.utils.tree import tree_leaves

    engine, backend, p0 = make_slice(torch, model, x, y)
    topology = SLICE_TOPOLOGY[model]
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    hist = engine.run(backend)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()

    rep = engine.report
    vals = [r.value for r in hist]
    leaves = [tuple(l.shape) for l in tree_leaves(p0)]
    per_client = sum(math.prod(s) + 4 for s in leaves)   # int8 + one scale
    log(f"[slice] {model} ({topology}, int8): rounds {rep.rounds_total}, "
        f"iterations {rep.iters_total}, wall {wall:.2f} s, objective "
        f"{vals[0]:.6f} -> {vals[-1]:.6f}, comm bytes "
        f"{rep.comm_bytes_total}, launches {counts}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{model}: non-finite objective")
    if not vals[-1] < 0.9 * vals[0]:
        raise AssertionError(f"{model}: objective {vals[-1]} did not fall "
                             f"below 0.9 x {vals[0]}")
    if (rep.rounds_total, rep.iters_total) != (96, 3584):
        raise AssertionError(f"{model}: ran {rep.rounds_total} rounds, "
                             f"{rep.iters_total} iterations")
    expect = rep.rounds_total * N_CLIENTS * per_client
    if rep.comm_bytes_total != expect:
        raise AssertionError(f"{model}: ledger {rep.comm_bytes_total} != "
                             f"{expect}")
    if model == "logreg" and expect != 96 * 32 * (784 + 4):
        raise AssertionError("logreg ledger formula")
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"{model}: a kernel was not launched: {counts}")
    return counts, wall


def profile_slice(torch, model: str, x, y, rounds: int = 4):
    """Phase 4b: where a round's time goes — torch.profiler over a few
    rounds of the slice (first stage, k = 16), after one warm-up run."""
    warm, warm_backend, _ = make_slice(torch, model, x, y, n_stages=1,
                                       max_rounds=1, chunk_rounds=1)
    warm.run(warm_backend)
    engine, backend, _ = make_slice(torch, model, x, y, n_stages=1,
                                    max_rounds=rounds, chunk_rounds=rounds)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        engine.run(backend)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    steps = engine.report.iters_total
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    if not kern:
        log(f"[profile] {model}: wall {wall * 1e3 / steps:.3f} ms per local "
            f"step; device time not measured (no CUDA events traced)")
        return
    log(f"[profile] {model}: {steps} local steps, {engine.report.rounds_total}"
        f" rounds in {wall * 1e3:.1f} ms under the profiler: "
        f"{wall * 1e3 / steps:.3f} ms per step, {n_kern / steps:.1f} kernels "
        f"per step, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / (wall * 1e6):.1f}% of wall)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")


def sdpa_library(torch, q, k, v):
    """The one PyTorch call computing causal GQA attention without softcap
    (``scaled_dot_product_attention``), in the port's (B, S, H, D) layout;
    timed beside the kernel, used nowhere in the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def check_flash(torch):
    """Phase 5: flash attention against its plain version, and its times."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         bf16_mismatch)
    from repro_torch.launch.flops import _attn_pairs

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    # label: (B, S, H, KV, D, dtype, window, softcap)
    cases = {
        "local": (1, 4608, 32, 16, 128, bf, 4096, 50.0),
        "global": (1, 4608, 32, 16, 128, bf, None, 50.0),
        "causal": (1, 4608, 32, 16, 128, bf, None, None),
        "ragged": (1, 1000, 32, 16, 128, bf, None, 50.0),
        "f32": (2, 300, 8, 4, 128, f32, 128, 50.0),
    }
    rows = {}
    for label, (B, S, H, KV, D, dt, window, cap) in cases.items():
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
        k = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
        kern = lambda: flash_attention(q, k, v, window=window, softcap=cap)
        plain = lambda: attention_ref(q, k, v, window=window,
                                      softcap=cap).to(dt)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if dt == bf:
            # ref.py's bf16 tolerance: elementwise |d| <= 5e-3 + 1e-2 |ref|
            # and per (row, head) ||d|| <= 1e-2 ||ref||, as ratios <= 1
            err, elem, row = bf16_mismatch(out, ref)
            tol_txt = f"elementwise {elem:.3f}, per-row {row:.3f} of tol"
        else:
            # f32: the same float32 products summed in another order
            diff = (out.float() - ref.float()).abs()
            err, row = float(diff.max()), None
            elem = float((diff / (1e-5 + 1e-5 * ref.abs())).max())
            tol_txt = f"{elem:.3f} of 1e-5 + 1e-5 |ref|"
        if not (elem <= 1.0 and (row is None or row <= 1.0)):
            raise AssertionError(f"flash_attention {label}: max err {err}, "
                                 f"{tol_txt}")
        lib, lib_err = None, None
        if cap is None and window is None:
            lib_out = sdpa_library(torch, q, k, v)
            torch.cuda.synchronize()
            lib_err, lib_elem, lib_row = bf16_mismatch(lib_out, ref)
            log(f"[flash] SDPA against the plain version: max err "
                f"{lib_err:.3g}, elementwise {lib_elem:.3f}, per-row "
                f"{lib_row:.3f} of tol")
            if not (lib_elem <= 1.0 and lib_row <= 1.0):
                raise AssertionError(f"SDPA {label}: max err {lib_err}")
            lib = device_ms(torch, lambda: sdpa_library(torch, q, k, v),
                            batch=2, reps=10)
        del out, ref
        big = S > 2000
        ms = device_ms(torch, kern, batch=2 if big else 10,
                       reps=10 if big else TIMING_REPS)
        plain_ms = device_ms(torch, plain, batch=1 if big else 10,
                             reps=5 if big else TIMING_REPS)
        one = call_ms(torch, kern, reps=10 if big else TIMING_REPS)
        pairs = _attn_pairs(S, window, "prefill")
        n_flops = 4.0 * B * H * D * pairs
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bms, by = bound_ms(n_bytes, n_flops,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        rows[label] = {"shape": [B, S, H, KV, D], "dtype": str(dt),
                       "window": window, "softcap": cap, "ms": ms,
                       "plain_ms": plain_ms, "call_ms": one,
                       "library_ms": lib, "bound_ms": bms, "bound_by": by,
                       "max_abs_err": err, "elem_of_tol": elem,
                       "row_of_tol": row, "tflops": n_flops / ms / 1e9}
        lib_txt = "-" if lib is None else f"{lib:.3f} ms (err {lib_err:.3g})"
        log(f"[flash] {label:6s} {tuple(q.shape)} {dt} window {window} "
            f"softcap {cap}: device {ms:.3f} ms, one call {one:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library {lib_txt}, bound "
            f"{bms:.4f} ms ({by}), {n_flops / ms / 1e9:.1f} TFLOP/s; "
            f"max_abs_err {err:.3g}, {tol_txt}")
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def serve_reference_check(torch):
    """Phase 6: gemma2-27b SMOKE in float32 on the card against the CPU
    run (plain versions) on the same weights: an 80-token prompt (longer
    than the window of 64) through ``prefill``, then 8 decode steps fed
    the CPU run's tokens. Max logit difference 1e-4: float32 on both sides
    (TF32 off), sums in another order through two layers, logits at most
    30 after the final softcap."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF
    from repro_torch.utils.tree import tree_map

    cfg = get_arch("gemma2-27b", smoke=True).replace(dtype="float32")
    p_cpu = TF.init_params(cfg, seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to("cuda:0"), p_cpu)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, 80))).long()
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda:0", p_gpu)):
        cache = TF.init_cache(cfg, 1, 96, device=dev)
        logits, cache = TF.prefill(params, cfg, prompt.to(dev), cache)
        steps = [logits[:, -1].cpu()]
        toks = runs["cpu"]["toks"] if dev != "cpu" else []
        for i in range(8):
            if dev == "cpu":
                toks.append(torch.argmax(steps[-1], dim=-1)[:, None])
            logits, cache = TF.decode_step(params, cfg, toks[i].to(dev),
                                           cache)
            steps.append(logits[:, -1].cpu())
        runs[dev] = {"toks": toks, "logits": torch.stack(steps)}
    err = float((runs["cpu"]["logits"] - runs["cuda:0"]["logits"]).abs()
                .max())
    log(f"[reference] gemma2-27b smoke f32, 80-token prompt + 8 decode "
        f"steps: card vs CPU max |logit diff| {err:.3g} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"serve reference: card vs CPU {err}")


def serve_full_width(torch):
    """Phase 7: gemma2-27b at full width behind ServeEngine."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.serving import greedy_decode
    from repro_torch.models import transformer as TF
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.series import SeriesRegistry
    from repro_torch.serve import (Request, SchedulerConfig, ServeEngine,
                                   TrafficConfig, generate_requests)
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device("cuda:0")
    cfg = get_arch("gemma2-27b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = TF.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] gemma2-27b: {n_params / 1e9:.2f} B params in {cfg.dtype}"
        f" made on the card in {time.monotonic() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    sched = SchedulerConfig(n_slots=4, max_seq_len=6144)
    eng = ServeEngine(cfg, params, scheduler=sched)
    rate = 0.7 * sched.n_slots / eng.decode_step_s   # launch/serve's rule
    reqs = generate_requests(TrafficConfig(
        process="poisson", n_requests=6, mean_prompt_len=512,
        max_prompt_len=2048, mean_out_len=16, max_out_len=32, seed=0,
        rate_rps=rate), cfg.vocab_size)
    long_prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(4608,)).astype(np.int32)
    reqs.append(Request(id=6, arrival_s=reqs[2].arrival_s,
                        prompt=long_prompt, n_out=24))
    log(f"[serve] requests (prompt, n_out): "
        f"{[(r.prompt_len, r.n_out) for r in reqs]}; rate {rate:.1f} rps, "
        f"modeled decode step {eng.decode_step_s * 1e3:.3f} ms")

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    report = eng.run(reqs, registry=MetricsRegistry(),
                     series=SeriesRegistry())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.tokens) for r in report.records)
    log(f"[serve] run: {report.n_prefills} prefills, {report.n_steps} decode"
        f" steps, {tokens} tokens in {wall:.2f} s wall ({tokens / wall:.2f} "
        f"tok/s measured, {report.modeled_tok_s:.1f} tok/s modeled), "
        f"modeled makespan {report.makespan_s:.4f} s, mean occupancy "
        f"{report.mean_occupancy:.2f}, peak memory {peak / 1e9:.2f} GB, "
        f"launches {counts}")
    if len(report.completed) != len(reqs) or any(
            len(r.tokens) != r.n_out for r in report.records):
        raise AssertionError("serve: not every request completed")
    if counts["flash_attention"] != cfg.n_layers * report.n_prefills:
        raise AssertionError(f"serve: flash_attention launched "
                             f"{counts['flash_attention']} times for "
                             f"{report.n_prefills} prefills")
    if not math.isfinite(report.makespan_s) or report.makespan_s <= 0:
        raise AssertionError(f"serve: makespan {report.makespan_s}")

    compared = total = 0
    for r, rec in zip(reqs, report.records):
        prompt = torch.as_tensor(r.prompt[None], dtype=torch.long,
                                 device=dev)
        ref, margin = greedy_decode(params, cfg, prompt, r.n_out,
                                    sched.max_seq_len)
        ref, margin = ref[0].tolist(), margin[0].tolist()
        if rec.tokens[0] != ref[0]:
            raise AssertionError(f"serve: request {r.id} first token "
                                 f"{rec.tokens[0]} != greedy {ref[0]}")
        n = 1
        for i in range(1, r.n_out):
            if margin[i] < MARGIN_TOL:
                break
            if rec.tokens[i] != ref[i]:
                raise AssertionError(
                    f"serve: request {r.id} token {i}: {rec.tokens[i]} != "
                    f"greedy {ref[i]} at top-2 margin {margin[i]:.3f}")
            n += 1
        compared += n
        total += r.n_out
        log(f"[serve] request {r.id}: prompt {r.prompt_len}, slot "
            f"{rec.slot}, {n}/{r.n_out} tokens compared, equal to "
            f"greedy_decode (min margin {min(margin):.3f})")
    log(f"[serve] tokens held to greedy_decode: {compared} of {total}")
    del eng
    torch.cuda.empty_cache()
    step = time_serve_steps(torch, cfg, params, sched, reqs)
    return {"wall_s": wall, "tok_s": tokens / wall, "tokens": tokens,
            "n_prefills": report.n_prefills, "n_steps": report.n_steps,
            "peak_gb": peak / 1e9, "makespan_s": report.makespan_s,
            "modeled_tok_s": report.modeled_tok_s,
            "tokens_compared": compared, "tokens_total": total,
            "flash_launches": counts["flash_attention"], **step}


def time_serve_steps(torch, cfg, params, sched, reqs):
    """Host-clock times (synchronized) of a 512-token and the 4,608-token
    prefill and of the 4-slot decode step, then torch.profiler over one
    prefill and 4 decode steps: the top device ops."""
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda:0")
    stacked = TF.init_cache(cfg, sched.n_slots, sched.max_seq_len, device=dev)
    toks = torch.zeros((sched.n_slots, 1), dtype=torch.long, device=dev)
    long_prompt = torch.as_tensor(reqs[-1].prompt[None], dtype=torch.long,
                                  device=dev)
    prompts = {512: long_prompt[:, :512], 4608: long_prompt}

    def prefill(n, slot=0):
        logits, _ = TF.prefill(params, cfg, prompts[n],
                               TF.cache_rows(stacked, slot, slot + 1))
        return logits

    out = {}
    with torch.no_grad():
        for n in (512, 4608):
            prefill(n)                   # warm-up
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                t0 = time.monotonic()
                prefill(n)
                torch.cuda.synchronize()
                ts.append(time.monotonic() - t0)
            out[f"prefill_{n}_ms"] = statistics.median(ts) * 1e3
        for slot in range(sched.n_slots):
            prefill(512, slot)
        TF.decode_step(params, cfg, toks, stacked)
        torch.cuda.synchronize()
        ts = []
        for _ in range(8):
            t0 = time.monotonic()
            TF.decode_step(params, cfg, toks, stacked)
            torch.cuda.synchronize()
            ts.append(time.monotonic() - t0)
        out["decode_step_ms"] = statistics.median(ts) * 1e3
        log(f"[serve] prefill 512 tokens {out['prefill_512_ms']:.1f} ms, "
            f"prefill 4608 tokens {out['prefill_4608_ms']:.1f} ms, decode "
            f"step (4 slots) {out['decode_step_ms']:.2f} ms (host clock, "
            f"synchronized, median)")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            prefill(512)
            for _ in range(4):
                TF.decode_step(params, cfg, toks, stacked)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern:
        log(f"[profile] serve: {wall * 1e3:.1f} ms; device time not "
            f"measured (no CUDA events traced)")
        return out
    log(f"[profile] serve, one 512-token prefill + 4 decode steps: wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / (wall * 1e6):.1f}% of "
        f"wall), {sum(e.count for e in kern)} kernels")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    out["profile_busy_ms"] = busy_us / 1e3
    out["profile_wall_ms"] = wall * 1e3
    return out


def main() -> int:
    import torch

    # phase 1: environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.data import make_binary_classification
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {name}")
    smi = nvidia_smi_line()
    log(smi)

    # phase 2: build
    t0 = time.monotonic()
    build.library()
    log(f"[build] kernels built and loaded in "
        f"{time.monotonic() - t0:.2f} s ({build.build()})")

    # phase 3: kernels against their plain versions
    mlp_leaves = {"mlp w0": 784 * 96, "mlp w1": 96 * 96, "mlp b": 96,
                  "mlp out.w": 96, "mlp out.b": 1}
    shapes = {"logreg theta": (N_CLIENTS, 784)}
    shapes.update({k: (N_CLIENTS, v) for k, v in mlp_leaves.items()})
    shapes["large"] = (N_CLIENTS, 1 << 20)
    rows = check_kernels(torch, shapes)

    # phase 4: the slice
    small_reference_check(torch)
    x, y = make_binary_classification(n=11791, d=784, seed=0)
    launches = {}
    for model in ("logreg", "mlp"):
        counts, _ = run_slice(torch, model, x, y)
        for k in TRAIN_KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]
    for model in ("logreg", "mlp"):
        profile_slice(torch, model, x, y)

    # phases 5-7: flash attention, then the serving path
    flash = check_flash(torch)
    serve_reference_check(torch)
    torch.cuda.empty_cache()
    serve = serve_full_width(torch)
    launches["flash_attention"] = serve["flash_launches"]

    # phase 8: summary
    meta = {
        "fused_sgd_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                             "src/repro/kernels/fused_update/kernel.py:33"),
        "quantize_kernel": ("src/repro_torch/kernels/csrc/quantize.cu",
                            "src/repro/kernels/quantize/kernel.py:65"),
        "dequant_mean_kernel": ("src/repro_torch/kernels/csrc/quantize.cu",
                                "src/repro/kernels/quantize/kernel.py:98"),
    }
    out = []
    for kname, (src, replaces) in meta.items():
        r = rows[(kname, "logreg theta")]
        big = rows[(kname, "large")]
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": max(rows[(kname, s)]["max_abs_err"]
                                       for s in shapes),
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "shape": [N_CLIENTS, 784],
                    "large": {"shape": list(shapes["large"]),
                              "ms": big["ms"], "plain_ms": big["plain_ms"],
                              "library_ms": big["library_ms"],
                              "bound_ms": big["bound_ms"]}})
    g = flash["global"]   # gemma2-27b's global layer at the 4,608-token prefill
    out.append({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
                "launches": launches["flash_attention"],
                "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
                "ms": g["ms"], "plain_ms": g["plain_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                "library_ms": g["library_ms"], "shape": g["shape"],
                "shapes": flash})
    log(json.dumps({"kernels": out, "serve": serve, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
