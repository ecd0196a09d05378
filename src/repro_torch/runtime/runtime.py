"""EventBackend — discrete-event execution backend for heterogeneous clients.

The second ``Engine.run`` backend of the port, next to
``core.simulate.VmapSimulatorBackend``: every client is a simulated
process with its own compute rate and α–β uplink, and a virtual clock
prices the run in *modeled wall-clock seconds* instead of round counts —
the axis for comparing STL-SGD's growing k_s against asynchronous merging
under stragglers.

Two execution regimes, selected by the Algorithm's SyncPolicy:

  synchronous (EveryStep / FixedPeriod / Stagewise* / AdaptivePeriod)
      The parent (``VmapSimulatorBackend.run_stage``) runs the stage, so
      the numerics are the simulator's. The event layer then replays each
      executed round on the clock through an *upload schedule*
      (``runtime.schedule``): blocking rounds emit per-client compute-done
      and arrival events and a barrier merge at the latest arrival
      (stragglers stretch every round); streaming rounds
      (``cfg.upload_schedule="streaming"``) emit per-leaf arrivals that
      start during the final local step — clock only, the trajectory is
      the same under both schedules. With ``dropout > 0`` a
      per-(round, client) mask, drawn through the parent's
      ``_sample_round_masks`` hook, freezes dropped clients for the round;
      the reduce still spans all N replicas (a dropped client contributes
      a zero delta, which keeps error feedback sound).

  asynchronous (AsyncPeriod — ``engine.make_async`` / ``cfg.async_mode``)
      No barrier: the stage's budget of N·T_s local steps is consumed
      greedily. Each client loops pull → k local steps → upload; the
      server merges each message on arrival through a
      ``comm.StalenessWeightedMean`` reducer (staleness counted in server
      cycles, error-feedback residuals per client, dense or int<b>
      messages). Fast clients contribute more steps; stragglers' late
      deltas are staleness-decayed instead of stalling the cohort.

The port updates tensors in place (the fused update kernel writes the
parameters and moments it is given), where the JAX package's arrays are
immutable. So in the asynchronous regime each client steps a parameter
buffer of its own, into which a pull *copies* the server model; the
server model is never written in place (``merge`` returns a new tree), so
the tree a client pulled stays the reference its delta is taken from; and
a dropped job's moments are restored from a copy taken before it.

Under a two-level ``engine.Hierarchical`` topology the clients' uploads
are the intra-pod hop; the inter-pod hop is added to each barrier
serially, or, when the schedule streams the whole round, forwarded leaf
by leaf over the WAN as soon as every pod holds the leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.cost import NetworkModel, leaf_elems
from repro_torch.comm.reducer import (DenseMean, StalenessWeightedMean,
                                      get_reducer, supports_leaf_bytes)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.simulate import (
    _COMM_SALT,
    Record,
    VmapSimulatorBackend,
    _eta_t,
    make_batch_weights,
    one_client_sgd_step,
)
from repro_torch.engine.algorithm import get_algorithm, make_async
from repro_torch.engine.engine import Engine, StageStatus
from repro_torch.engine.topology import Hierarchical, Star
from repro_torch.obs.trace import (CAT_COMM, CAT_COMPUTE, CAT_CONTROL,
                                   CAT_MERGE, VIRTUAL)
from repro_torch.runtime.client import Heterogeneity, sample_clients
from repro_torch.runtime.clock import Clock, EventQueue, TraceEntry
from repro_torch.runtime.schedule import UploadSchedule, get_schedule
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (tree_broadcast_leading, tree_leaves,
                                    tree_map, tree_mean_leading)

log = get_logger("runtime")

# numpy stream salt for the dropout draws (separate from the client sampler)
_DROPOUT_SEED_SALT = 0x0D0D


def staleness_reducer_for(cfg: TrainConfig,
                          reducer=None) -> StalenessWeightedMean:
    """Async merge reducer from a TrainConfig.

    ``cfg.reducer`` (or the explicit ``reducer`` spec) picks the message
    compression — dense float32 deltas or int<b> stochastic-rounding codes
    (the same kernels as ``QuantizedMean``); ``cfg.staleness_decay`` sets
    the (1+τ)^(−decay) merge weight. Top-k has no merge-on-arrival
    encoding.
    """
    spec = reducer if reducer is not None else cfg.reducer
    if isinstance(spec, StalenessWeightedMean):
        return spec
    if spec in (None, "dense", "mean"):
        spec = "staleness"
    elif spec in ("quant", "quantized"):
        spec = f"staleness-int{cfg.quant_bits}"
    elif isinstance(spec, str) and spec.startswith("int"):
        spec = f"staleness-{spec}"
    if not (isinstance(spec, str) and spec.startswith("staleness")):
        raise ValueError(
            f"async rounds carry dense or int<b> messages, got "
            f"reducer {spec!r}")
    return get_reducer(spec, staleness_decay=cfg.staleness_decay,
                       quant_bits=cfg.quant_bits)


def _copy_into_(dst, src):
    """dst's leaves ← src's leaves (same shapes), in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


class EventBackend(VmapSimulatorBackend):
    """Engine backend: simulated clients on a shared discrete-event clock.

    Heterogeneity disabled ⇒ the synchronous path gives the
    ``VmapSimulatorBackend`` history exactly; the clock then simply prices
    homogeneous barrier rounds. Extra attributes after a run: ``clock.now``
    (modeled seconds), ``trace`` (the event log), ``timeline``
    ((time_s, round, objective) samples).
    """

    def __init__(self, loss_fn, init_params, client_data, eval_fn, *,
                 device=None, hetero: Optional[Heterogeneity] = None,
                 merge_reducer=None, schedule=None, eval_every: int = 1,
                 max_rounds: Optional[int] = None,
                 target: Optional[float] = None, lr_alpha: float = 0.0,
                 chunk_rounds: int = 32, rng=None):
        super().__init__(loss_fn, init_params, client_data, eval_fn,
                         device=device, eval_every=eval_every,
                         max_rounds=max_rounds, target=target,
                         lr_alpha=lr_alpha, chunk_rounds=chunk_rounds,
                         rng=rng)
        self._hetero_arg = hetero
        self._merge_arg = merge_reducer
        self._schedule_arg = schedule

    # -- setup ---------------------------------------------------------------

    def setup(self, engine: Engine):
        """Backend-contract setup: allocate simulator state (via the
        parent), sample the client cohort, build clock/queue/trace, and
        resolve the upload schedule + per-leaf payload/compute splits."""
        super().setup(engine)
        cfg = engine.cfg
        self.N = tree_leaves(self.client_data)[0].shape[0]
        self.hetero = (self._hetero_arg if self._hetero_arg is not None
                       else Heterogeneity.from_config(cfg))
        net = NetworkModel(latency_s=cfg.comm_latency_s,
                           bandwidth_gbps=cfg.comm_bandwidth_gbps,
                           count_downlink=cfg.count_downlink)
        self.clients = sample_clients(self.N, self.hetero, net)
        self.clock = Clock()
        # runtime log records carry the virtual timestamp alongside the
        # host's monotonic one
        log.bind_clock(self.clock)
        self.queue = EventQueue()
        self.trace: List[TraceEntry] = []
        self.timeline: List[Tuple[float, int, float]] = [
            (0.0, 0, self.history[0].value)]
        self._np = np.random.RandomState(
            (self.hetero.seed + _DROPOUT_SEED_SALT) % (2 ** 31))
        self._round_times: List[float] = []
        self._stage_masks: List[np.ndarray] = []
        self._tracer = engine.tracer
        self._metrics = engine.metrics
        self._series = engine.series
        self.asynchronous = bool(
            getattr(engine.algorithm.sync_policy, "asynchronous", False))

        topo = engine.topology
        # the clients' uploads: the Star's uplink, or the intra-pod hop
        first_hop = (topo.intra if isinstance(topo, Hierarchical)
                     else topo.reducer)
        self._msg_bytes = first_hop.message_bytes(self.init_params)
        hops = topo.hop_costs(self.init_params, self.N)
        # hops beyond the first add to the barrier serially — except the
        # downlink, which broadcast_events prices per client after the
        # merge, and (below) a per-leaf-streamed WAN hop
        self._extra_hop_time = sum(h.time_s for h in hops[1:]
                                   if h.hop != "downlink")

        # upload schedule: what events one client's round-end message emits.
        # Per-leaf payload bytes come from the uplink reducer; per-leaf
        # compute fractions (share of one local step) from parameter counts.
        self.schedule: UploadSchedule = get_schedule(
            self._schedule_arg if self._schedule_arg is not None
            else cfg.upload_schedule)
        if supports_leaf_bytes(first_hop):
            # explicit capability probe (not except NotImplementedError):
            # an exception from an *implemented* per-leaf method must
            # propagate, never degrade to monolithic blob pricing
            self._leaf_bytes = first_hop.leaf_message_bytes(self.init_params)
            sizes = [leaf_elems(l) for l in tree_leaves(self.init_params)]
        else:
            if self.schedule.streams_uplink:
                raise ValueError(
                    f"reducer {first_hop!r} has no per-leaf payload "
                    "accounting (leaf_message_bytes); streaming uploads "
                    "need it — implement the per-leaf protocol or use the "
                    "blocking schedule")
            # blocking schedules only ever sum the list: one opaque blob
            self._leaf_bytes, sizes = [self._msg_bytes], [1]
        total = float(sum(sizes))
        self._leaf_fracs = [s / total for s in sizes]
        # the downlink ships the dense consensus whatever the uplink
        # reducer; per-client pricing happens in schedule.broadcast_events
        self._down_bytes = DenseMean().leaf_message_bytes(self.init_params)
        self._ready = [0.0] * self.N   # per-client next-round start times
        # streaming∘hierarchical: the full streaming schedule forwards each
        # leaf over the inter-pod WAN link as soon as every pod holds it,
        # overlapping the WAN hop with the intra-pod reduction of the
        # remaining leaves (in place of the serial _extra_hop_time)
        self._stream_wan = (isinstance(topo, Hierarchical)
                            and self.schedule.streams_round)
        if self._stream_wan:
            if not supports_leaf_bytes(topo.inter):
                raise ValueError(
                    f"inter-pod reducer {topo.inter!r} has no per-leaf "
                    "payload accounting (leaf_message_bytes); streaming "
                    "the WAN hop needs it — implement the per-leaf "
                    "protocol or use upload_schedule='streaming-uplink'")
            self._wan_leaf_bytes = [
                topo.n_pods * b
                for b in topo.inter.leaf_message_bytes(self.init_params)]
            self._wan_net = topo.inter_net
            self._extra_hop_time = 0.0
        if self.asynchronous and self.schedule.name != "blocking":
            raise ValueError(
                f"upload_schedule={self.schedule.name!r} prices per-leaf "
                "streaming of barriered rounds; AsyncPeriod merges whole "
                "messages on arrival — run streaming with a synchronous "
                "policy (drop async_mode / the '+async' suffix)")

        if self.asynchronous:
            red = self._merge_arg
            if red is None and isinstance(first_hop, StalenessWeightedMean):
                red = first_hop
            if red is None:
                red = staleness_reducer_for(cfg)
            self.merge_reducer: StalenessWeightedMean = red
            self._msg_bytes = red.message_bytes(self.init_params)
            # one merge = one client upload: re-price the engine ledger
            # per-message (the event clock owns end-to-end wall time)
            engine.set_cost_basis(self.init_params, 1)
            # the async path keeps per-client EF residuals (_c_res); the
            # stacked topology state the parent built would otherwise pin
            # ~N+1 unused model copies for the whole run
            self.comm_state = None
            self.server = self.init_params
            self.server_version = 0
            self._c_data = [tree_map(lambda a: a[i], self.client_data)
                            for i in range(self.N)]
            # each client's own parameter buffer, which its jobs step in
            # place; a pull copies the server model into it
            self._c_params = [tree_map(torch.clone, self.server)
                              for _ in range(self.N)]
            self._c_mom = [tree_map(torch.zeros_like, self.server)
                           for _ in range(self.N)]
            self._c_res = [red.client_residual(self.server)
                           for _ in range(self.N)]
            self._c_t = [0.0] * self.N
            self._batch_weights = make_batch_weights(
                self.batch, self.grow, cfg.batch_per_client, cfg.max_batch,
                self.device)

    # -- synchronous regime --------------------------------------------------

    def run_stage(self, stage, engine: Engine) -> StageStatus:
        """Backend-contract stage execution: synchronous policies run the
        parent's numerics then replay the executed rounds on the clock;
        AsyncPeriod policies consume the stage budget merge-on-arrival."""
        if self.asynchronous:
            return self._run_stage_async(stage, engine)
        if self.hetero.dropout > 0.0 \
                and getattr(engine.algorithm.sync_policy, "adaptive", False):
            raise ValueError(
                "AdaptivePeriod's divergence probe assumes full "
                "participation; dropout composes with the fixed-period "
                "policies and the async runtime only")
        hist_mark = len(self.history)
        self._stage_masks = []
        # the parent runs the stage; dropout (if any) threads through the
        # _sample_round_masks override below
        status = super().run_stage(stage, engine)
        if not self._stage_masks:  # full participation
            self._stage_masks = [np.ones(self.N, dtype=bool)
                                 for _ in self._last_round_steps]
        self._replay_rounds(self._last_round_steps, self._stage_masks)
        for rec in self.history[hist_mark:]:
            if rec.round >= 1:
                self.timeline.append(
                    (self._round_times[rec.round - 1], rec.round, rec.value))
        return status

    def _trace_client_round(self, tracer, c, start: float, kk: int,
                            events, active: bool):
        """Virtual-clock spans for one client's replayed barrier round:
        ``local_steps`` [round start, compute_done], then either one
        ``reduce`` upload span (blocking — the α–β transfer window) or one
        ``reduce_leaf`` serialization span per streamed leaf (the β window
        only; the stream's α is paid once at open and shows as the gap
        before the first leaf)."""
        track = f"client/{c.cid}"
        for t, kind, info in events:
            if kind == "compute_done":
                tracer.add("local_steps", start, t, cat=CAT_COMPUTE,
                           track=track, clock=VIRTUAL,
                           attrs={"steps": kk, "straggler": c.straggler})
            elif kind == "arrival":
                total = sum(self._leaf_bytes)
                tracer.add("reduce", t - c.upload_time(total), t,
                           cat=CAT_COMM, track=track, clock=VIRTUAL,
                           attrs={"bytes": total, "active": active})
            elif kind == "leaf_arrival":
                leaf = info[0]
                ser = self._leaf_bytes[leaf] / c.network.bandwidth_Bps
                tracer.add("reduce_leaf", t - ser, t, cat=CAT_COMM,
                           track=track, clock=VIRTUAL,
                           attrs={"leaf": leaf,
                                  "bytes": self._leaf_bytes[leaf],
                                  "active": active})

    def _vseries(self, name: str, unit: str, help: str):
        return self._series.series(name, clock=VIRTUAL, unit=unit, help=help)

    def _stream_wan_hop(self, leaf_max: List[float], tracer):
        """Stream the inter-pod WAN hop per leaf (streaming∘hierarchical).

        Leaf l can cross the WAN once every pod holds its reduced value —
        ``leaf_max[l]``, the latest intra-pod arrival. Leaves forward in
        reverse-leaf order over one serial WAN stream: α_wan is paid once
        when the stream opens, then each leaf serializes at β_wan as soon
        as it is ready and the link is free. Returns ``(leaf_done,
        merge_t)``: per-leaf global-consensus times and the barrier merge
        (the last leaf's WAN landing).
        """
        net = self._wan_net
        link_free = None
        leaf_done = [0.0] * len(self._wan_leaf_bytes)
        merge_t = 0.0
        for leaf in range(len(self._wan_leaf_bytes) - 1, -1, -1):
            ready = leaf_max[leaf]
            if link_free is None:
                link_free = ready + net.latency_s  # WAN stream opens once
            send = max(ready, link_free)
            ser = self._wan_leaf_bytes[leaf] / net.bandwidth_Bps
            fin = send + ser
            link_free = fin
            leaf_done[leaf] = fin
            merge_t = max(merge_t, fin)
            self.trace.append((fin, "wan_leaf", -1, leaf))
            if tracer:
                tracer.add("reduce_leaf", fin - ser, fin, cat=CAT_COMM,
                           track="server/wan", clock=VIRTUAL,
                           attrs={"leaf": leaf, "hop": "inter_pod",
                                  "bytes": self._wan_leaf_bytes[leaf]})
        return leaf_done, merge_t

    def _broadcast_round(self, leaf_done: List[float], tracer) -> None:
        """Price each client's downlink and stage its next-round start.

        ``schedule.broadcast_events`` turns the server's per-leaf finish
        times into the client's broadcast arrivals (free on links that
        don't bill the downlink); the returned ready time is when that
        client may begin the next round's local compute. The events land
        in the trace with their (post-merge) timestamps but the clock is
        not advanced past the merge — the run's wall-clock is when the
        consensus exists at the server, and the next round's queue drain
        picks up from each client's ready time.
        """
        for c in self.clients:
            events, ready = self.schedule.broadcast_events(
                c, leaf_done, self._down_bytes)
            for t, kind, info in events:
                self.trace.append((t, kind, c.cid) + info)
                if not tracer:
                    continue
                if kind == "leaf_broadcast":
                    leaf = info[0]
                    ser = self._down_bytes[leaf] / c.network.bandwidth_Bps
                    tracer.add("broadcast_leaf", t - ser, t, cat=CAT_COMM,
                               track=f"client/{c.cid}", clock=VIRTUAL,
                               attrs={"leaf": leaf,
                                      "bytes": self._down_bytes[leaf]})
                else:  # broadcast_arrival: one monolithic transfer window
                    total = sum(self._down_bytes)
                    tracer.add("broadcast",
                               t - total / c.network.bandwidth_Bps, t,
                               cat=CAT_COMM, track=f"client/{c.cid}",
                               clock=VIRTUAL, attrs={"bytes": total})
            self._ready[c.cid] = ready

    def _replay_rounds(self, round_steps: List[int], masks: List[np.ndarray]):
        """Advance the event clock over the executed barrier rounds.

        Each client's round becomes events via the upload schedule —
        blocking: compute_done then one arrival; streaming: per-leaf
        arrivals that start during the final local step (the overlap the
        clock then prices). A dropped client skipped its local compute
        window but still answers the barrier with its zero-delta message,
        so it schedules upload-only arrivals. Client c's round starts at
        its own broadcast-ready time from the previous round (all equal
        to the previous merge when the downlink is unbilled); after the
        merge the downlink is priced per client via ``broadcast_events``.
        """
        tracer = self._tracer
        dropouts = self._metrics.counter(
            "runtime.dropout_events", unit="events",
            help="uploads lost / rounds missed to dropout")
        s_active = self._vseries(
            "runtime.active_clients", "clients",
            "clients participating in the barrier round / holding work")
        s_round = self._vseries(
            "runtime.round_time_s", "s",
            "virtual-clock duration of each barrier round")
        n_leaves = len(self._leaf_bytes)
        for kk, mask in zip(round_steps, masks):
            start = self.clock.now
            s_active.record(start, float(int(mask.sum())))
            rid = tracer.begin(
                "round", start, cat=CAT_CONTROL, track="server",
                clock=VIRTUAL,
                attrs={"k": kk, "schedule": self.schedule.name}) \
                if tracer else None
            for c in self.clients:
                active = bool(mask[c.cid])
                start_c = self._ready[c.cid]
                if not active:
                    self.trace.append((start_c, "dropout", c.cid))
                    dropouts.inc(mode="sync")
                    if tracer:
                        tracer.instant("dropout", start_c, cat=CAT_CONTROL,
                                       track=f"client/{c.cid}",
                                       clock=VIRTUAL)
                events, _ = self.schedule.round_events(
                    c, start_c, kk, self._leaf_bytes, self._leaf_fracs,
                    active=active)
                if tracer:
                    self._trace_client_round(tracer, c, start_c, kk, events,
                                             active)
                for t, kind, info in events:
                    self.queue.push(t, kind, c.cid, info)
            merge_t = start
            leaf_max = [start] * n_leaves
            while self.queue:
                ev = self.queue.pop()
                self.clock.advance(ev.time)
                # per-leaf events stay attributable: leaf_arrival entries
                # are (time, kind, client, leaf index)
                self.trace.append((ev.time, ev.kind, ev.client) + ev.info)
                merge_t = max(merge_t, ev.time)
                if ev.kind == "leaf_arrival":
                    leaf = ev.info[0]
                    leaf_max[leaf] = max(leaf_max[leaf], ev.time)
            if self._stream_wan:
                # per-leaf WAN forwarding replaces the serial barrier add
                leaf_done, merge_t = self._stream_wan_hop(leaf_max, tracer)
            elif self.schedule.streams_round:
                # flat star: the server finishes leaf l at its last arrival
                merge_t += self._extra_hop_time
                leaf_done = leaf_max
            else:
                # blocking barrier (or uplink-only streaming): the whole
                # round merges at once, extra hops added serially
                merge_t += self._extra_hop_time
                leaf_done = [merge_t] * len(self._down_bytes)
            self.clock.advance(merge_t)
            self.trace.append((merge_t, "merge", -1))
            self._round_times.append(merge_t)
            s_round.record(merge_t, merge_t - start)
            if tracer:
                tracer.instant("broadcast", merge_t, cat=CAT_COMM,
                               track="server", clock=VIRTUAL)
            self._broadcast_round(leaf_done, tracer)
            if tracer:
                tracer.end(rid, merge_t)

    def _sample_round_masks(self, n: int):
        """Dropout masks for the parent's next n rounds (None = no dropout).

        Sampled from the backend's seeded numpy stream in execution order,
        so the masks — and therefore the trace and the trajectory — are a
        pure function of (config, seed).
        """
        if self.asynchronous or self.hetero.dropout <= 0.0:
            return None
        masks = self._np.random_sample((n, self.N)) >= self.hetero.dropout
        self._stage_masks.extend(masks)
        return masks

    # -- asynchronous regime -------------------------------------------------

    def _job(self, engine: Engine, kk: int, key, cid: int, center,
             eta: float):
        """kk local steps of ONE client on its own buffers, in place: one
        fused update launch per step on the client's (unstacked) tree."""
        cfg = engine.cfg
        params, mom = self._c_params[cid], self._c_mom[cid]
        t = self._c_t[cid]
        for r in key.split(kk):
            one_client_sgd_step(self.wloss, self.batch, cfg.momentum, params,
                                mom, self._c_data[cid], r, center,
                                self._batch_weights(t),
                                _eta_t(eta, self.lr_alpha, t))
            t += 1.0
        self._c_t[cid] = t

    def _run_stage_async(self, stage, engine: Engine) -> StageStatus:
        """Barrier-free stage: budget = N·T_s local steps consumed greedily;
        the server merges each upload on arrival with staleness weights.
        Stage boundaries are the only barriers (η_s changes, prox re-centers,
        every client re-pulls the server model)."""
        red = self.merge_reducer
        status = StageStatus()
        hist_mark = len(self.history)
        tracer = self._tracer
        dropouts = self._metrics.counter(
            "runtime.dropout_events", unit="events",
            help="uploads lost / rounds missed to dropout")
        staleness_hist = self._metrics.histogram(
            "runtime.merge_staleness", unit="server cycles (normalized)",
            help="staleness weight input of async merges")
        s_active = self._vseries(
            "runtime.active_clients", "clients",
            "clients participating in the barrier round / holding work")
        s_inflight = self._vseries(
            "runtime.inflight_merges", "uploads",
            "async uploads in flight toward the server")
        s_stale = self._vseries(
            "runtime.merge_staleness", "server cycles (normalized)",
            "staleness weight input of each async merge")
        n_uploading = 0
        # stage-start barrier: everyone pulls the current server model
        for i in range(self.N):
            _copy_into_(self._c_params[i], self.server)
        center = self.server if self.use_prox else None
        budget = self.N * stage.T
        # cid -> (kk, key, pulled_version, ref | payload); ref is the server
        # tree the client pulled, which no merge writes in place
        inflight: dict = {}
        stopping = False

        def dispatch(cid: int):
            nonlocal budget
            kk = min(stage.k, budget)
            if kk <= 0 or stopping:
                return
            budget -= kk
            self.rng, sub = self.rng.split(2)
            c = self.clients[cid]
            inflight[cid] = (kk, sub, self.server_version, self.server)
            self.queue.push(self.clock.now + c.compute_time(kk),
                            "compute_done", cid)

        def record(now: float, v: float):
            self.history.append(Record(self.rounds_done, self.iters_done, v))
            self.timeline.append((now, self.rounds_done, v))

        for cid in range(self.N):
            dispatch(cid)

        while self.queue:
            ev = self.queue.pop()
            now = self.clock.advance(ev.time)
            self.trace.append((ev.time, ev.kind, ev.client))
            cid = ev.client
            c = self.clients[cid]
            if ev.kind == "compute_done":
                kk, sub, v_pull, ref = inflight.pop(cid)
                if tracer:
                    tracer.add("local_steps", now - c.compute_time(kk), now,
                               cat=CAT_COMPUTE, track=f"client/{cid}",
                               clock=VIRTUAL,
                               attrs={"steps": kk,
                                      "straggler": c.straggler})
                # the job steps the moments in place: a job that may be
                # dropped keeps a copy of them to restore
                pre_mom = (tree_map(torch.clone, self._c_mom[cid])
                           if self.hetero.dropout > 0.0 else None)
                pre_t = self._c_t[cid]
                self._job(engine, kk, sub, cid, center, stage.eta)
                self.iters_done += kk
                status.iters += kk
                if self.hetero.dropout > 0.0 \
                        and self._np.random_sample() < self.hetero.dropout:
                    # upload lost: the whole job is discarded — params back
                    # to the server pull, momentum and schedule index back
                    # to their pre-job values (the steps count as wasted
                    # compute in the ledger, not as optimizer progress)
                    self.trace.append((now, "drop", cid))
                    dropouts.inc(mode="async")
                    if tracer:
                        tracer.instant("drop", now, cat=CAT_CONTROL,
                                       track=f"client/{cid}", clock=VIRTUAL)
                    _copy_into_(self._c_params[cid], self.server)
                    self._c_mom[cid], self._c_t[cid] = pre_mom, pre_t
                    dispatch(cid)
                    s_active.record(now, float(len(inflight)))
                    continue
                delta = tree_map(
                    lambda p, r: p.to(torch.float32) - r.to(torch.float32),
                    self._c_params[cid], ref)
                payload, self._c_res[cid] = red.encode(
                    delta, self._c_res[cid], sub.fold_in(_COMM_SALT))
                inflight[cid] = (kk, v_pull, payload)
                self.queue.push(now + c.upload_time(self._msg_bytes),
                                "arrival", cid)
                n_uploading += 1
                s_inflight.record(now, float(n_uploading))
                s_active.record(now, float(len(inflight)))
            elif ev.kind == "arrival":
                kk, v_pull, payload = inflight.pop(cid)
                n_uploading -= 1
                s_inflight.record(now, float(n_uploading))
                # cycles beyond the natural pipeline lag: racing the other
                # N-1 clients' merges once is keeping pace, not staleness
                staleness = max(
                    0, self.server_version - v_pull - (self.N - 1)) / self.N
                if tracer:
                    tracer.add("reduce",
                               now - c.upload_time(self._msg_bytes), now,
                               cat=CAT_COMM, track=f"client/{cid}",
                               clock=VIRTUAL,
                               attrs={"bytes": self._msg_bytes})
                    tracer.instant("merge", now, cat=CAT_MERGE,
                                   track="server", clock=VIRTUAL,
                                   attrs={"client": cid,
                                          "staleness": staleness})
                staleness_hist.observe(staleness, reducer=red.name)
                s_stale.record(now, float(staleness))
                self.server = red.merge(self.server, payload, staleness,
                                        self.N)
                self.server_version += 1
                status.rounds += 1
                self.rounds_done += 1
                self._round_times.append(now)
                # target-hunting evaluates every merge (matching the sync
                # backend's per-round check); otherwise only the recorded
                # eval_every-th merges pay for an eval
                if not stopping and (self.target is not None
                                     or self.rounds_done
                                     % self.eval_every == 0):
                    v = float(self.eval_fn(self.server))
                    at_target = self.target is not None and v <= self.target
                    if at_target or self.rounds_done % self.eval_every == 0:
                        record(now, v)
                    if at_target:
                        stopping = True
                        status.stop = True
                if self.max_rounds is not None \
                        and self.rounds_done >= self.max_rounds:
                    stopping = True
                    status.stop = True
                _copy_into_(self._c_params[cid], self.server)
                dispatch(cid)
                s_active.record(now, float(len(inflight)))

        # stage-end barrier: drain done above; record the closing objective
        v = float(self.eval_fn(self.server))
        if not self.history[hist_mark:] \
                or self.history[-1].round != self.rounds_done:
            record(self.clock.now, v)
        if self.target is not None and v <= self.target:
            status.stop = True
        # keep the stacked view coherent for finish()/cross-stage consumers
        self.params = tree_broadcast_leading(self.server, self.N)
        return status


@dataclass
class RuntimeResult:
    """What a discrete-event run produced, numerics and clock together."""

    history: List[Record]              # (round, iteration, objective) trace
    wall_clock_s: float                # modeled end-to-end wall time
    rounds: int
    iters: int
    comm_bytes: int                    # engine ledger (modeled payload bytes)
    comm_time_s: float                 # engine ledger (serial α–β link time)
    timeline: List[Tuple[float, int, float]]  # (time_s, round, objective)
    # full event log; per-leaf entries ("leaf_arrival", "leaf_broadcast")
    # carry the leaf index as a fourth element (see clock.TraceEntry)
    trace: List[TraceEntry]
    params: Any = None                 # final consensus / server model
    # per-(leaf, hop) comm totals for the whole run (engine.leaf_ledger():
    # modeled payload bytes + serial α–β seconds per leaf); None when the
    # topology has no per-leaf accounting. Summing the entries reconciles
    # with comm_bytes (exactly) and comm_time_s (float-sum precision).
    leaf_ledger: Optional[List[dict]] = None


def run(loss_fn, init_params, client_data, cfg: TrainConfig, eval_fn, *,
        device=None, eval_every: int = 1, max_rounds: Optional[int] = None,
        target: Optional[float] = None, lr_alpha: float = 0.0,
        chunk_rounds: int = 32, reducer=None, topology=None,
        hetero: Optional[Heterogeneity] = None, schedule=None, tracer=None,
        series=None, rng=None) -> RuntimeResult:
    """Run ``cfg.algo`` on the event runtime; the ``simulate.run`` of clocks.

    Same problem signature as ``core.simulate.run``. ``device`` — None
    means CUDA, and the call raises when CUDA is absent (pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels).
    ``cfg.async_mode`` (or an ``algo`` name carrying the ``+async``
    suffix) switches to barrier-free merge-on-arrival rounds; the
    heterogeneity profile comes from the TrainConfig runtime fields unless
    ``hetero`` overrides it. ``cfg.upload_schedule`` (or the explicit
    ``schedule`` arg) picks how round-end uploads meet the clock —
    "blocking" monolithic messages or "streaming" per-leaf uploads
    overlapping the final local step. With heterogeneity disabled and a
    synchronous policy, ``.history`` equals ``simulate.run``'s — for
    *both* schedules: streaming changes modeled time only, never the
    trajectory. ``rng`` — the root random key (default
    ``TorchKey(cfg.seed, device)``).
    """
    algo = get_algorithm(cfg.algo)
    if cfg.async_mode:
        algo = make_async(algo)
    if algo.sync_policy.asynchronous:
        if topology is not None:
            raise ValueError(
                "asynchronous merging builds its own "
                "Star(StalenessWeightedMean); configure the messages via "
                "reducer=/cfg fields instead of passing topology=")
        if cfg.topology not in (None, "star", "flat"):
            raise ValueError(
                "asynchronous merging is a flat star protocol; "
                f"topology={cfg.topology!r} only composes with barrier rounds")
        if cfg.count_downlink:
            raise ValueError(
                "count_downlink prices the per-round consensus broadcast; "
                "asynchronous merging has no broadcast (clients pull on "
                "dispatch) — it composes with barrier rounds only")
        merge_red = staleness_reducer_for(cfg, reducer)
        net = NetworkModel(latency_s=cfg.comm_latency_s,
                           bandwidth_gbps=cfg.comm_bandwidth_gbps)
        engine = Engine(algo, cfg, topology=Star(reducer=merge_red,
                                                 network=net),
                        tracer=tracer, series=series)
    else:
        engine = Engine(algo, cfg, topology=topology, reducer=reducer,
                        tracer=tracer, series=series)
    backend = EventBackend(loss_fn, init_params, client_data, eval_fn,
                           device=device, hetero=hetero, schedule=schedule,
                           eval_every=eval_every, max_rounds=max_rounds,
                           target=target, lr_alpha=lr_alpha,
                           chunk_rounds=chunk_rounds, rng=rng)
    history = engine.run(backend)
    log.debug("runtime_done", wall_clock_s=backend.clock.now,
              rounds=engine.report.rounds_total,
              iters=engine.report.iters_total,
              comm_bytes=engine.report.comm_bytes_total,
              asynchronous=backend.asynchronous)
    final = (backend.server if backend.asynchronous
             else tree_mean_leading(backend.params))
    return RuntimeResult(
        history=history, wall_clock_s=backend.clock.now,
        rounds=engine.report.rounds_total, iters=engine.report.iters_total,
        comm_bytes=engine.report.comm_bytes_total,
        comm_time_s=engine.report.comm_time_s,
        timeline=backend.timeline, trace=backend.trace, params=final,
        leaf_ledger=engine.leaf_ledger() or None)
