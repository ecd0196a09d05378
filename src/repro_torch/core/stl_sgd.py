"""STL-SGD stagewise driver over (train_step_local, sync_step) pairs.

The port of ``src/repro/core/stl_sgd.py``. Per stage s the SyncPolicy
fixes η_s, the driver runs T_s local iterations and triggers the
parameter-averaging round every ⌊k_s⌋ steps; for the ^nc variants the
loss is the prox surrogate f^γ centered at the stage-start average.

``StagewiseDriver.run`` hands a ``DriverBackend`` to the same
``engine.Engine`` that drives the simulator, so both front-ends consume
one stage stream and one topology-priced comm ledger. The driver is
step-function-agnostic: the tests drive it with tiny CPU models, the
launcher with ``core.local_sgd``'s transformer steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.comm import NetworkModel, get_reducer, link_model
from repro_torch.configs.base import TrainConfig
from repro_torch.core.local_sgd import sync_step_tags
from repro_torch.core.simulate import _gather_batch
from repro_torch.engine.algorithm import get_algorithm
from repro_torch.engine.engine import Engine, StageStatus
from repro_torch.engine.topology import Hierarchical, Star, StreamingStar
from repro_torch.obs.trace import CAT_COMM, CAT_COMPUTE, layer
from repro_torch.utils.logging import get_logger
from repro_torch.utils.rng import TorchKey
from repro_torch.utils.tree import (tree_broadcast_leading, tree_leaves,
                                    tree_map, tree_mean_leading)

log = get_logger("stl_sgd")


def driver_state(params, n_clients: int) -> dict:
    """Stacked {"params", "opt", "step"} driver state from one replica:
    every client starts from the same ``params`` (each its own copy),
    momentum buffers zeroed, step counter 0."""
    stacked = tree_broadcast_leading(params, n_clients)
    return {"params": stacked,
            "opt": {"mu": tree_map(torch.zeros_like, stacked)},
            "step": 0}


def make_client_sgd_step(loss_fn, client_data, batch: int, seed: int = 1,
                         rng=None):
    """Ready-made ``train_step`` over stacked client data shards.

    One minibatch SGD step per client on its own shard of ``client_data``
    (a tree with leading client axis), all clients at once
    (``torch.func.vmap``); the minibatch indices come from
    ``fold_in(key(seed), state["step"])`` split per client — ``rng``
    replaces ``key(seed)`` (default ``TorchKey(seed)``) — so the batch
    stream needs no payload (drive the driver with
    ``itertools.repeat(None)``). Returns new params; nothing is updated
    in place.
    """
    leaves = tree_leaves(client_data)
    n_clients, n = leaves[0].shape[0], leaves[0].shape[1]
    grad = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def train_step(state, _, eta):
        root = rng if rng is not None else TorchKey(seed, leaves[0].device)
        idx = root.fold_in(int(state["step"])).batch_indices(
            n_clients, batch, n).to(leaves[0].device)
        g, losses = grad(state["params"], _gather_batch(client_data, idx))
        params = tree_map(lambda a, gg: a - eta * gg, state["params"], g)
        return dict(state, params=params, step=state["step"] + 1), {
            "loss": torch.mean(losses)}

    return train_step


@dataclass
class StageResult:
    stage: int
    eta: float
    k: int
    iters: int
    rounds: int
    mean_loss: float


@dataclass
class DriverState:
    state: dict                 # {"params","opt","step"} with client axis
    center: Optional[dict] = None  # prox center (^nc)
    results: List[StageResult] = field(default_factory=list)
    rounds_total: int = 0
    iters_total: int = 0
    comm_bytes_total: int = 0      # modeled bytes moved by sync rounds
    comm_time_s: float = 0.0       # α–β modeled wall-clock of those rounds
    # per-(leaf, hop) totals ({"leaf","path","hop","bytes","time_s"}); sums
    # reconcile with the tree-level totals above (bytes exactly, seconds to
    # float-sum precision)
    leaf_ledger: List[dict] = field(default_factory=list)


class DriverBackend:
    """Engine backend: a stream of step calls on real batches.

    Profiler ranges (``obs/trace.layer``): ``driver.batch`` around each
    batch drawn from the stream, ``driver.loss_read`` around each step's
    loss read (the step's one intended host sync), and, from the driver's
    wall spans, ``driver.local_steps`` and ``driver.reduce``. A ``reduce``
    span's wall length is the round's enqueue, not its device time: under
    a ``Tracer`` with the state on CUDA the round is also timed between
    two CUDA events, and the span gets that as ``device_ms`` after a
    later loss read has synchronised (or when the run finishes).
    """

    def __init__(self, driver: "StagewiseDriver", ds: DriverState, batches,
                 max_iters: Optional[int]):
        self.driver = driver
        self.ds = ds
        self.it = iter(batches)
        self.max_iters = max_iters
        self.rounds_timed = []     # (reduce span, start event, end event)

    def _round_events(self, tracer):
        """A CUDA event pair for timing a round, where one is wanted."""
        if not tracer or not tree_leaves(self.ds.state["params"])[0].is_cuda:
            return None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _read_round_times(self):
        """Give each timed round's span its ``device_ms``: called after a
        synchronisation, so its end event has been reached."""
        for span, e0, e1 in self.rounds_timed:
            span.set(device_ms=e0.elapsed_time(e1))
        self.rounds_timed.clear()

    def setup(self, engine: Engine):
        params = self.ds.state["params"]
        engine.set_cost_basis(tree_map(lambda x: x[0], params),
                              tree_leaves(params)[0].shape[0])

    def run_stage(self, stage, engine: Engine) -> StageStatus:
        drv, ds = self.driver, self.ds
        if drv.uses_center:
            ds.center = tree_mean_leading(ds.state["params"])
        losses = []
        status = StageStatus()
        done = 0
        tracer = engine.tracer
        while done < stage.T:
            burst = min(stage.k, stage.T - done)
            with tracer.span("local_steps", cat=CAT_COMPUTE, track="driver",
                             attrs={"s": stage.s, "steps": burst,
                                    "eta": stage.eta}):
                for _ in range(burst):
                    with layer("driver.batch"):
                        batch = next(self.it)
                    if drv.uses_center:
                        ds.state, m = drv.train_step(ds.state, batch,
                                                     stage.eta, ds.center)
                    else:
                        ds.state, m = drv.train_step(ds.state, batch,
                                                     stage.eta)
                    with layer("driver.loss_read"):
                        losses.append(float(m["loss"]))
                    if self.rounds_timed:
                        self._read_round_times()
                    done += 1
                    ds.iters_total += 1
                    if self.max_iters and ds.iters_total >= self.max_iters:
                        break
            events = self._round_events(tracer)
            with tracer.span("reduce", cat=CAT_COMM, track="driver",
                             attrs=dict(drv.span_attrs, s=stage.s)) as sp:
                if events:
                    events[0].record()
                ds.state = drv.sync_step(ds.state)
                if events:
                    events[1].record()
                    self.rounds_timed.append((sp, *events))
            status.rounds += 1
            ds.rounds_total += 1
            if self.max_iters and ds.iters_total >= self.max_iters:
                status.stop = True
                break
        status.iters = done
        res = StageResult(stage.s, stage.eta, stage.k, done, status.rounds,
                          float(np.mean(np.asarray(losses, np.float32)))
                          if losses else float("nan"))
        ds.results.append(res)
        engine.metrics.gauge(
            "train.stage_objective", unit="loss",
            help="mean training loss per stage").set(res.mean_loss,
                                                     stage=res.stage)
        log.info("stage_done", stage=res.stage, eta=res.eta, k=res.k,
                 iters=res.iters, rounds=res.rounds, loss=res.mean_loss)
        return status

    def finish(self, engine: Engine) -> DriverState:
        for _, _, e1 in self.rounds_timed:
            e1.synchronize()
        self._read_round_times()
        self.ds.comm_bytes_total = engine.report.comm_bytes_total
        self.ds.comm_time_s = engine.report.comm_time_s
        self.ds.leaf_ledger = engine.leaf_ledger()
        return self.ds


class StagewiseDriver:
    """Runs cfg.algo over a stream of batches.

    train_step(state, batch, eta[, center]) -> (state, metrics)
    sync_step(state) -> state

    The sync round's *shape* follows the sync_step's tags (set by
    ``local_sgd.build_sync_step``; ``tcfg.topology`` must agree with
    them): flat star (default), per-leaf streaming star
    (``streaming=True``), or the two-level hierarchical round
    (``hierarchical=True``; ``tcfg.n_pods`` / ``tcfg.inter_reducer``).
    The engine prices exactly that topology, so
    ``DriverState.comm_bytes_total`` and the per-(leaf, hop)
    ``leaf_ledger`` describe the round the step executes.
    """

    def __init__(self, tcfg: TrainConfig, train_step: Callable,
                 sync_step: Callable, uses_center: bool = False,
                 reducer=None):
        self.tcfg = tcfg
        self.train_step = train_step
        self.sync_step = sync_step
        self.uses_center = uses_center
        # accounting reducer: explicit arg > the sync_step's tag >
        # tcfg.reducer, so the ledger prices what the round transmits
        tags = sync_step_tags(sync_step)

        def tag(name, default=None):
            v = tags.get(name)
            return default if v is None else v

        if reducer is None:
            reducer = tag("reducer")
        self.reducer = get_reducer(
            reducer if reducer is not None else tcfg.reducer,
            quant_bits=tcfg.quant_bits, topk_frac=tcfg.topk_frac)
        topo_spec = getattr(tcfg, "topology", "star")
        stream_hier_specs = ("streaming-hier", "hier-streaming",
                             "streaming-hierarchical")
        hier_spec = (topo_spec in ("hier", "hierarchical", "pods")
                     or topo_spec in stream_hier_specs)
        # a streaming-tagged sync_step implies the per-leaf round even when
        # the config says plain "star"
        self.streaming = (topo_spec in ("streaming", "streaming-star",
                                        "stream")
                          or topo_spec in stream_hier_specs
                          or bool(tag("streaming", False)))
        # ... and a hierarchical-tagged one the two-level round (n_pods=1
        # is the flat degenerate case)
        self.hierarchical = bool(tag("hierarchical", False)) or (
            hier_spec and getattr(tcfg, "n_pods", 2) > 1)
        if self.hierarchical:
            if not tag("hierarchical", False):
                # the config promises a two-level round, the step transmits
                # a flat average: the ledger would price bytes never moved
                raise ValueError(
                    f"topology={tcfg.topology!r} needs a two-level sync "
                    f"step: build it with local_sgd.build_sync_step("
                    f"reducer, hierarchical=True, n_pods={tcfg.n_pods}, "
                    f"inter_reducer={tcfg.inter_reducer!r})")
            n_pods = tag("n_pods")
            if hier_spec and n_pods != tcfg.n_pods:
                raise ValueError(
                    f"sync_step reduces over {n_pods} pods but the config "
                    f"says n_pods={tcfg.n_pods}; the ledger would price a "
                    f"different topology than the round executes")
            self.n_pods = n_pods
            self.inter_reducer = get_reducer(
                tag("inter_reducer", getattr(tcfg, "inter_reducer", "int8")),
                quant_bits=tcfg.quant_bits, topk_frac=tcfg.topk_frac)
            cfg_inter = get_reducer(getattr(tcfg, "inter_reducer", "int8"),
                                    quant_bits=tcfg.quant_bits,
                                    topk_frac=tcfg.topk_frac)
            if hier_spec and tag("inter_reducer") is not None \
                    and self.inter_reducer.name != cfg_inter.name:
                raise ValueError(
                    f"sync_step compresses the inter-pod hop with "
                    f"{self.inter_reducer.name!r} but the config says "
                    f"inter_reducer={tcfg.inter_reducer!r}; the ledger "
                    f"would price a different round than the one executed")
        elif topo_spec not in (None, "star", "flat", "streaming",
                               "streaming-star", "stream") and not hier_spec:
            raise ValueError(
                f"unknown topology spec for StagewiseDriver: "
                f"{tcfg.topology!r} (expected star/streaming/hierarchical/"
                f"streaming-hier)")
        self.net = NetworkModel(
            latency_s=tcfg.comm_latency_s,
            bandwidth_gbps=tcfg.comm_bandwidth_gbps,
            count_downlink=getattr(tcfg, "count_downlink", False))
        self.algorithm = get_algorithm(tcfg.algo)
        policy = self.algorithm.sync_policy
        if getattr(policy, "asynchronous", False):
            raise ValueError(
                f"StagewiseDriver runs barriered fixed-schedule rounds, but "
                f"algorithm {self.algorithm.name!r} carries the asynchronous "
                f"{type(policy).__name__} policy (merge-on-arrival, no "
                f"barrier). Run it on the event runtime instead: "
                f"repro_torch.runtime.run / repro_torch.runtime.EventBackend")
        if getattr(policy, "adaptive", False):
            raise ValueError(
                f"StagewiseDriver runs barriered fixed-schedule rounds, but "
                f"algorithm {self.algorithm.name!r} carries the "
                f"{type(policy).__name__} policy, whose divergence probe "
                f"decides each round at runtime. Run it on the simulator "
                f"(core.simulate.run) or the event runtime "
                f"(repro_torch.runtime.EventBackend)")
        self.stages = self.algorithm.stages(tcfg)
        # trace-span attributes of one sync round, from the tags the
        # ledger prices
        self.span_attrs = {"reducer": self.reducer.name,
                           "streaming": self.streaming,
                           "hierarchical": self.hierarchical}
        if self.hierarchical:
            self.span_attrs.update(n_pods=self.n_pods,
                                   inter_reducer=self.inter_reducer.name)

    def build_topology(self):
        """The priced Topology of one sync round — the round the tagged
        sync_step executes. Streaming prices as Star (same bytes and
        serial α–β time) with a per-leaf ledger; hierarchical rounds price
        per hop (the ICI preset intra-pod, the config's link inter-pod)."""
        if self.hierarchical:
            return Hierarchical(n_pods=self.n_pods, intra=self.reducer,
                                inter=self.inter_reducer,
                                intra_net=link_model("ici"),
                                inter_net=self.net,
                                streaming=self.streaming)
        topo_cls = StreamingStar if self.streaming else Star
        return topo_cls(reducer=self.reducer, network=self.net)

    def run(self, state: dict, batches, max_iters: Optional[int] = None,
            tracer=None, series=None) -> DriverState:
        # a fresh Engine per run: its report is the run's comm ledger
        engine = Engine(self.algorithm, self.tcfg,
                        topology=self.build_topology(),
                        tracer=tracer, series=series)
        ds = engine.run(DriverBackend(self, DriverState(state=state),
                                      batches, max_iters))
        log.info("comm_summary", reducer=self.reducer.name,
                 rounds=ds.rounds_total, comm_bytes=ds.comm_bytes_total,
                 comm_time_s=ds.comm_time_s)
        return ds
