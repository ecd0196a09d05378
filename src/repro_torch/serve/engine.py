"""Continuous-batching inference engine over a fixed cache slot pool.

The port of ``src/repro/serve/engine.py:62-412``. ``ServeEngine.run``
serves an open-loop request list: requests join free slots at decode-step
boundaries and finished sequences retire without draining the batch.

Execution model
---------------
The decode batch is always ``n_slots`` wide. The JAX package vmaps a
batch-1 ``decode_step`` over a stacked cache; here the stacked cache IS a
batch-``n_slots`` cache (``TF.init_cache(cfg, n_slots, max_seq_len)``)
whose ``pos`` holds one position per slot, and one ``decode_step`` call
decodes every slot: each writes its K/V at its own ring index and gets its
own mask, or updates its own Mamba2 state. A prefill writes straight into
its slot's rows of the stacked cache through a view (``TF.cache_rows``),
in place, where JAX donated the buffers: no second copy of a
gigabyte-sized slot; it zeroes a reused slot's Mamba2 state first. Slot rows are
independent, so a slot's tokens are those of the per-request
``greedy_decode``; on the card the batched and single-row products may
round differently in bfloat16.

Two timelines
-------------
Time is *modeled* on the ``runtime.clock`` virtual clock: arrivals come
from ``traffic.offered_load``, prefills and decode steps advance the clock
by roofline prices (``launch/flops.py`` over ``DeviceModel``, plus an
α–β activation all-reduce when the modeled mesh has >1 chip). Same traffic
seed ⇒ identical event order and latency ledger. Host wall time is
measured alongside and never fed back into scheduling.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint
from repro_torch.comm.cost import NetworkModel, link_model
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.serving import build_prefill_step, build_serve_step
from repro_torch.core.simulate import resolve_device
from repro_torch.launch.flops import shape_flops
from repro_torch.models import transformer as TF
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import series as obs_series
from repro_torch.obs.trace import CAT_COMPUTE, VIRTUAL
from repro_torch.runtime.clock import Clock
from repro_torch.serve import ledger as serve_ledger
from repro_torch.serve.ledger import RequestRecord
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.traffic import Request, offered_load
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_map

log = get_logger("serve")

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
H100_PEAK_FLOPS_BF16 = 989e12
H100_HBM_BW = 3.35e12


@dataclass(frozen=True)
class DeviceModel:
    """Hardware model pricing one serve step in modeled seconds.

    Roofline: ``max(step_flops / (n_chips × peak), hbm_bytes / (n_chips ×
    bw))``. Defaults are the H100 SXM's (NVIDIA data sheet). With
    ``n_chips > 1`` the modeled mesh shards the step, and every step also
    pays one α–β activation all-reduce on ``link`` (2 × tokens × d_model
    bf16 bytes per layer, the ring-collective payload that model-sharded
    decode cannot hide), as the JAX package prices it. The default link is
    the JAX package's modeled ICI preset (``comm/cost.py::link_model``,
    ``_REF_ICI_BW``), kept so that both packages price a step alike: a
    modeling constant of the reference, not a measurement of any NVIDIA
    interconnect.
    """

    peak_flops: float = H100_PEAK_FLOPS_BF16
    hbm_bw: float = H100_HBM_BW
    n_chips: int = 1
    link: Optional[NetworkModel] = None    # default: link_model("ici")

    def _link(self) -> NetworkModel:
        return self.link if self.link is not None else link_model("ici")

    def step_time_s(self, cfg: ArchConfig, shape: ShapeConfig) -> float:
        fr = shape_flops(cfg, shape)
        t = max(fr.step_flops / (self.n_chips * self.peak_flops),
                fr.hbm_bytes / (self.n_chips * self.hbm_bw))
        if self.n_chips > 1:
            tokens = shape.global_batch * (1 if shape.mode == "decode"
                                           else shape.seq_len)
            coll = 2.0 * tokens * cfg.d_model * 2.0 * cfg.n_layers
            t += self._link().time(coll)
        return t


@dataclass
class ServeReport:
    """Everything one ``ServeEngine.run`` produced.

    ``records`` cover every offered request (completed and rejected, id
    order); modeled numbers are deterministic per seed, ``measured_*``
    are host wall-clock and vary run to run.
    """

    records: List[RequestRecord]
    n_steps: int                     # executed decode steps
    n_prefills: int
    makespan_s: float                # modeled: virtual clock at drain
    decode_step_s: float             # modeled price of one decode step
    mean_occupancy: float            # active slots averaged over steps
    modeled_tok_s: float             # generated tokens / modeled makespan
    measured_wall_s: float
    measured_tok_s: float
    registry: obs_metrics.MetricsRegistry = field(repr=False, default=None)
    series: obs_series.SeriesRegistry = field(repr=False, default=None)

    @property
    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records if r.outcome == "completed"]

    @property
    def rejected(self) -> List[RequestRecord]:
        return [r for r in self.records if r.outcome != "completed"]

    def latency_summary(self) -> Dict[str, dict]:
        """p50/p95/p99 (+count/mean) per latency family, straight from the
        ``serve.*`` obs histograms this run published."""
        out = {}
        for name in ("serve.queue_wait_s", "serve.ttft_s", "serve.tpot_s",
                     "serve.e2e_s"):
            if name in self.registry:
                s = self.registry[name].summary()
                if s is not None:
                    out[name] = s
        return out

    def trace_keys(self) -> list:
        """Deterministic fingerprint of the whole ledger (determinism
        tests compare these across same-seed runs and across packages)."""
        return [r.trace_key() for r in self.records]


@dataclass
class _SlotState:
    """Host-side view of one occupied slot."""

    record: RequestRecord
    generated: int                   # tokens produced so far (>= 1)


class ServeEngine:
    """Continuous-batching serving driver (see module docstring).

    ``params`` live on one device (``TF.init_params(..., device=)``); the
    caches and tokens are made there too.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 scheduler: Optional[SchedulerConfig] = None,
                 device: Optional[DeviceModel] = None):
        TF.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.sched_cfg = scheduler or SchedulerConfig()
        self.device = device or DeviceModel()
        self.max_seq_len = self.sched_cfg.max_seq_len
        self.n_slots = self.sched_cfg.n_slots
        self.torch_device = params["embed"].device
        self._prefill = build_prefill_step(cfg)
        self._decode = build_serve_step(cfg)
        # modeled price of one (always full-width) decode step
        self.decode_step_s = self.device.step_time_s(
            cfg, ShapeConfig("serve_decode", self.max_seq_len,
                             self.n_slots, "decode"))

    # -- construction -------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, directory: str, step: Optional[int] = None,
                        torch_device=None, **kwargs) -> "ServeEngine":
        """Restore a ``launch/train.py --ckpt-out`` artifact (either
        package's) and serve it on ``torch_device`` (None means CUDA).

        The template load needs an arch before it can build shapes, so the
        restore is two-phase: peek at the npz's ``__meta__`` for the arch
        name (and the depth trained, where the port's ``--layers`` cut it),
        build the params template (``init_params_shape``, in the training
        layout the checkpoint holds), then do the real shape/type-checked
        load and move the leaves to the device.
        """
        s = step if step is not None else latest_step(directory)
        if s is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        path = os.path.join(directory, f"step_{s:010d}.npz")
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if "arch" not in meta:
            raise ValueError(
                f"{path}: checkpoint meta has no 'arch' key — was it "
                "written by launch/train.py --ckpt-out?")
        cfg = get_arch(meta["arch"], smoke=bool(meta.get("smoke", False)))
        if meta.get("n_layers", cfg.n_layers) != cfg.n_layers:
            cfg = cfg.replace(n_layers=int(meta["n_layers"]))
        template = TF.to_grouped(TF.init_params_shape(cfg), cfg)
        params, meta = load_checkpoint(directory, template, step=s)
        dev = resolve_device(torch_device)
        params = TF.layer_views(tree_map(lambda t: t.to(dev), params), cfg)
        log.info("restored %s step=%d (algo=%s rounds=%s)", meta["arch"], s,
                 meta.get("algo"), meta.get("rounds"))
        return cls(cfg, params, **kwargs)

    # -- pricing ------------------------------------------------------------

    def prefill_s(self, req: Request) -> float:
        """Modeled cost of one request's prefill."""
        return self.device.step_time_s(
            self.cfg, ShapeConfig("serve_prefill", req.prompt_len, 1,
                                  "prefill"))

    # -- the loop -----------------------------------------------------------

    @torch.no_grad()
    def run(self, requests: List[Request], tracer=None,
            registry: Optional[obs_metrics.MetricsRegistry] = None,
            series: Optional[obs_series.SeriesRegistry] = None,
            profile=None) -> ServeReport:
        """Serve ``requests`` (open loop) until the system drains.

        ``series`` (default: the process registry) receives the live
        virtual-clock telemetry — ``serve.queue_depth`` /
        ``serve.batch_occupancy`` per decode step, the cumulative
        ``serve.tokens_total`` (plus its derived ``serve.tokens_s`` rate)
        and the per-request latency sample series. ``profile`` (an
        ``obs.ProfileSession``) wall-times every prefill/decode call,
        synchronised with the card, against its modeled price for the
        skew table.
        """
        if any(r.frontend is not None for r in requests):
            raise NotImplementedError("frontend embeddings are not ported "
                                      "yet (ROADMAP queue 1: frontend archs)")
        registry = registry or obs_metrics.registry()
        series = series if series is not None else obs_series.registry()
        s_queue = series.series(
            "serve.queue_depth", clock=VIRTUAL, unit="requests",
            help="waiting requests at each decode-step boundary")
        s_occ = series.series(
            "serve.batch_occupancy", clock=VIRTUAL, unit="slots",
            help="active slots in each decode step")
        s_tok = series.series(
            "serve.tokens_total", clock=VIRTUAL, unit="tokens",
            help="cumulative generated tokens (prefill + decode)")
        events = offered_load(requests)
        by_id = {r.id: r for r in requests}
        clock = Clock()
        sched = Scheduler(self.sched_cfg,
                          n_frontend_tokens=self.cfg.n_frontend_tokens)
        slots: List[Optional[_SlotState]] = [None] * self.n_slots
        records: Dict[int, RequestRecord] = {}

        dev = self.torch_device
        stacked = TF.init_cache(self.cfg, self.n_slots, self.max_seq_len,
                                device=dev)
        toks = torch.zeros((self.n_slots, 1), dtype=torch.long, device=dev)

        n_steps = n_prefills = 0
        occupancy_sum = 0
        tokens_out = 0
        gen_total = 0
        run_span = tracer.span("serve_run", track="server", attrs={
            "n_requests": len(requests), "n_slots": self.n_slots}) \
            if tracer else None
        if run_span:
            run_span.__enter__()
        t_wall0 = time.monotonic()

        def _offer(req: Request):
            rec = RequestRecord(id=req.id, prompt_len=req.prompt_len,
                                n_out=req.n_out, arrival_s=req.arrival_s)
            records[req.id] = rec
            if not sched.offer(req):
                too_long = any(r is req for r in sched.rejected_too_long)
                rec.outcome = ("rejected_too_long" if too_long
                               else "rejected_full")

        def _retire(slot: int, t: float):
            nonlocal tokens_out
            st = slots[slot]
            st.record.finish_s = t
            tokens_out += st.record.n_out
            sched.release(slot)
            slots[slot] = None

        while events or not sched.idle:
            # 1. arrivals due now enter admission control
            while events and events.peek().time <= clock.now:
                _offer(by_id[events.pop().client])
            # 2. idle system: jump to the next arrival
            if sched.idle:
                if not events:
                    break
                clock.advance(events.peek().time)
                continue
            # 3. step boundary: admissions join free slots (serialized
            #    prefills, capped by the interleaving policy)
            for adm in sched.admit():
                req, slot = adm.request, adm.slot
                rec = records[req.id]
                rec.slot, rec.admit_s = slot, clock.now
                prompt = torch.as_tensor(req.prompt[None, :],
                                         dtype=torch.long, device=dev)
                p_args = (self.params, TF.cache_rows(stacked, slot, slot + 1),
                          prompt)
                if profile is not None:
                    logits, _ = profile.step("serve.prefill",
                                             self.prefill_s(req),
                                             self._prefill, *p_args)
                else:
                    logits, _ = self._prefill(*p_args)
                tok1 = torch.argmax(logits[:, -1:], dim=-1)    # (1, 1)
                del logits
                toks[slot] = tok1[0]
                n_prefills += 1
                clock.advance(clock.now + self.prefill_s(req))
                rec.first_token_s = clock.now
                rec.tokens.append(int(tok1[0, 0]))
                rec.token_times_s.append(clock.now)
                gen_total += 1
                s_tok.record(clock.now, float(gen_total))
                slots[slot] = _SlotState(record=rec, generated=1)
                if rec.n_out == 1:
                    _retire(slot, clock.now)
            # 4. one decode step over the full slot pool
            active = [i for i, st in enumerate(slots) if st is not None]
            if active:
                t0 = clock.now
                s_queue.record(t0, float(sched.queue_depth))
                s_occ.record(t0, float(len(active)))
                if profile is not None:
                    logits, stacked = profile.step(
                        "serve.decode_step", self.decode_step_s,
                        self._decode, self.params, stacked, toks)
                else:
                    logits, stacked = self._decode(self.params, stacked,
                                                   toks)
                toks = torch.argmax(logits, dim=-1)            # (n_slots, 1)
                del logits
                clock.advance(clock.now + self.decode_step_s)
                n_steps += 1
                occupancy_sum += len(active)
                gen_total += len(active)
                s_tok.record(clock.now, float(gen_total))
                host_toks = toks.cpu().numpy()
                for i in active:
                    st = slots[i]
                    st.generated += 1
                    st.record.tokens.append(int(host_toks[i, 0]))
                    st.record.token_times_s.append(clock.now)
                    if st.generated >= st.record.n_out:
                        _retire(i, clock.now)
                if tracer:
                    tracer.add("decode_step", t0, clock.now,
                               cat=CAT_COMPUTE, track="server",
                               clock=VIRTUAL,
                               attrs={"active": len(active),
                                      "queued": sched.queue_depth})

        measured_wall_s = time.monotonic() - t_wall0
        if run_span:
            run_span.set(n_steps=n_steps, n_prefills=n_prefills)
            run_span.__exit__(None, None, None)

        recs = [records[r.id] for r in sorted(requests, key=lambda r: r.id)]
        serve_ledger.emit_spans(tracer, recs)
        serve_ledger.publish_metrics(registry, recs)
        serve_ledger.publish_series(series, recs)
        if len(s_tok):
            # windowed throughput over ~64 decode steps of virtual time
            series.add(s_tok.rate(64.0 * self.decode_step_s,
                                  name="serve.tokens_s"))
        makespan = clock.now
        mean_occ = occupancy_sum / n_steps if n_steps else 0.0
        g = registry.gauge
        g("serve.occupancy", unit="slots",
          help="mean active slots per decode step").set(mean_occ)
        g("serve.queue_depth", unit="requests",
          help="waiting requests at drain").set(sched.queue_depth)
        modeled_tok_s = tokens_out / makespan if makespan > 0 else 0.0
        g("serve.modeled_tok_s", unit="tokens/s",
          help="generated tokens over modeled makespan").set(modeled_tok_s)
        measured_tok_s = (tokens_out / measured_wall_s
                          if measured_wall_s > 0 else 0.0)
        g("serve.measured_tok_s", unit="tokens/s",
          help="generated tokens over host wall time").set(measured_tok_s)
        return ServeReport(
            records=recs, n_steps=n_steps, n_prefills=n_prefills,
            makespan_s=makespan, decode_step_s=self.decode_step_s,
            mean_occupancy=mean_occ, modeled_tok_s=modeled_tok_s,
            measured_wall_s=measured_wall_s, measured_tok_s=measured_tok_s,
            registry=registry, series=series)
