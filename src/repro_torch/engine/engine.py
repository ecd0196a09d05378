"""Engine — one stage-stream driver for every execution backend.

``Engine.run(backend)`` walks the Algorithm's stage stream (the SyncPolicy's
(η_s, T_s, k_s) schedule) and delegates stage execution to a *backend*:

  * ``core.simulate.VmapSimulatorBackend`` — N client replicas stacked on
    one device (the paper-fidelity convergence engine).

The distributed driver backend of the JAX package waits for a later slice
of the port. The engine owns the per-round byte/time ledger via its
Topology, so "rounds × bytes × modeled seconds" is computed once for every
backend.

Backend contract (duck-typed, see ``StageStatus``):

  setup(engine)               — allocate state; call
                                ``engine.set_cost_basis(template, n)`` so
                                the ledger can price rounds.
  run_stage(stage, engine) -> StageStatus
                              — run one stage (or a prefix of it, if a
                                target/budget stops the run early).
  finish(engine) -> result    — the front-end's native return value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.comm.cost import NetworkModel
from repro_torch.engine.algorithm import Algorithm, get_algorithm
from repro_torch.engine.topology import Topology, get_topology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import series as obs_series
from repro_torch.obs.trace import CAT_COMM, CAT_CONTROL, MODELED, NULL_TRACER
from repro_torch.utils.logging import get_logger

log = get_logger("engine")


@dataclass
class StageStatus:
    """What a backend did with one stage: ``rounds`` communication rounds
    executed and ``iters`` local iterations consumed (the engine scales
    both into the comm ledger), plus the early-exit flag."""

    rounds: int = 0
    iters: int = 0
    stop: bool = False   # target hit / budget exhausted — end the run


@dataclass
class EngineReport:
    """Cross-backend run ledger.

    Units: ``rounds_total`` / ``iters_total`` count communication rounds
    and local iterations; ``comm_bytes_total`` is modeled payload bytes
    moved by those rounds (all hops); ``comm_time_s`` their serial α–β
    link time in modeled seconds. ``hop_costs`` is the per-hop price of
    one round (``topology.HopCost``); ``leaf_costs`` the per-(leaf, hop)
    breakdown of the same round (``topology.LeafCost``, empty when the
    topology has no per-leaf accounting) — multiply by ``rounds_total``
    for run totals; the sums reconcile with the tree-level ledger.
    """

    rounds_total: int = 0
    iters_total: int = 0
    comm_bytes_total: int = 0
    comm_time_s: float = 0.0
    stages_run: int = 0
    hop_costs: List[Any] = field(default_factory=list)
    leaf_costs: List[Any] = field(default_factory=list)
    # obs.metrics / obs.series registry snapshots taken at run end
    metrics: dict = field(default_factory=dict)
    series: dict = field(default_factory=dict)


def topology_for(cfg, reducer=None, topology=None) -> Topology:
    """Resolve a Topology from a TrainConfig's comm fields.

    Priority: explicit ``topology`` arg > cfg.topology string. The reducer
    (explicit arg > cfg.reducer) becomes the Star uplink reducer, or the
    intra-pod reducer of a hierarchical topology (whose inter-pod reducer
    comes from cfg.inter_reducer, over cfg.n_pods pods).
    """
    if isinstance(topology, Topology):
        return topology
    net = NetworkModel(latency_s=cfg.comm_latency_s,
                       bandwidth_gbps=cfg.comm_bandwidth_gbps,
                       count_downlink=cfg.count_downlink)
    return get_topology(
        topology if topology is not None else cfg.topology,
        reducer=reducer if reducer is not None else cfg.reducer,
        network=net, n_pods=cfg.n_pods, inter_reducer=cfg.inter_reducer,
        quant_bits=cfg.quant_bits, topk_frac=cfg.topk_frac)


class Engine:
    """Drives one Algorithm over one Topology through one backend."""

    def __init__(self, algorithm, cfg, topology=None, reducer=None,
                 tracer=None, series=None):
        self.algorithm: Algorithm = get_algorithm(algorithm)
        self.cfg = cfg
        self.topology: Topology = topology_for(cfg, reducer=reducer,
                                               topology=topology)
        self.stages = self.algorithm.stages(cfg)
        self.report = EngineReport()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = obs_metrics.registry()
        self.series: obs_series.SeriesRegistry = (
            series if series is not None else obs_series.registry())
        self._bytes_per_round: Optional[int] = None
        self._time_per_round: Optional[float] = None
        self._modeled_t = 0.0   # cursor of the modeled α–β span timeline
        self._cum_bytes = 0     # modeled payload bytes up to the cursor

    # -- comm-cost ledger ---------------------------------------------------

    def set_cost_basis(self, template, n_clients: int):
        """Price one round for this run (template = single-replica pytree).

        Fills both ledger views: the per-hop tree-level costs and — when
        the topology supports it — the per-(leaf, hop) breakdown used by
        streaming rounds. Bytes are modeled payload bytes, times modeled
        seconds on the serial α–β link.
        """
        self._template = template
        self._n_clients = n_clients
        hops = self.topology.hop_costs(template, n_clients)
        self.report.hop_costs = hops
        self.report.leaf_costs = self.topology.leaf_costs(template, n_clients)
        self._bytes_per_round = sum(h.bytes for h in hops)
        self._time_per_round = sum(h.time_s for h in hops)

    def leaf_ledger(self) -> List[dict]:
        """Per-leaf comm totals for the rounds run so far.

        One dict per (leaf, hop): ``bytes`` (modeled payload bytes) and
        ``time_s`` (serial α–β seconds), each the per-round ``LeafCost``
        scaled by ``rounds_total``. Summing the entries reconciles with
        ``comm_bytes_total`` bit-exactly and ``comm_time_s`` to float-sum
        precision. Empty when the topology has no per-leaf accounting.
        """
        r = self.report.rounds_total
        return [{"leaf": lc.leaf, "path": lc.path, "hop": lc.hop,
                 "bytes": lc.bytes * r, "time_s": lc.time_s * r}
                for lc in self.report.leaf_costs]

    def comm_summary(self) -> dict:
        """Per-hop comm report for the rounds run so far."""
        return self.topology.summary(self._template, self._n_clients,
                                     self.report.rounds_total)

    # -- observability ------------------------------------------------------

    def _modeled_series(self, name: str, unit: str, help: str):
        return self.series.series(name, clock=MODELED, unit=unit, help=help)

    def trace_rounds(self, stage, rounds: int):
        """Advance the modeled α–β timeline by ``rounds`` rounds of
        ``stage``, emitting per-round series and — when a tracer is
        attached — round spans.

        The cursor arithmetic (per-hop sequential adds) is one code path
        whether or not spans are emitted, so the modeled timestamps on
        the ``comm.*`` series are bit-identical between traced and
        untraced runs and align exactly with the span end times.

        Each traced round lays its hops sequentially (``round`` >
        ``reduce[hop]`` > ``reduce_leaf[leaf]`` > ``broadcast`` marker),
        so summing the ``bytes`` attributes of all ``reduce_leaf`` spans
        reconciles bit-exactly with ``Engine.leaf_ledger()`` — both are
        ``rounds × LeafCost.bytes``.
        """
        if rounds <= 0:
            return
        tracer = self.tracer
        s_bytes = self._modeled_series(
            "comm.round_bytes", "B", "modeled payload bytes of each round")
        s_time = self._modeled_series(
            "comm.round_time_s", "s",
            "modeled serial α–β link seconds of each round")
        s_cum = self._modeled_series(
            "comm.cum_bytes", "B",
            "cumulative modeled payload bytes at each round boundary")
        leaf_by_hop: dict = {}
        if tracer:
            for lc in self.report.leaf_costs:
                leaf_by_hop.setdefault(lc.hop, []).append(lc)
        for r in range(rounds):
            t = self._modeled_t
            if tracer:
                rid = tracer.begin("round", t, cat=CAT_CONTROL,
                                   track="round", clock=MODELED,
                                   attrs={"s": stage.s, "eta": stage.eta,
                                          "k": stage.k})
            hop_t = t
            for hop in self.report.hop_costs:
                if tracer:
                    hid = tracer.begin(
                        "reduce", hop_t, cat=CAT_COMM,
                        track=f"hop/{hop.hop}", clock=MODELED,
                        attrs={"hop": hop.hop, "reducer": hop.reducer,
                               "bytes": hop.bytes, "time_s": hop.time_s})
                    leaf_t = hop_t
                    for lc in leaf_by_hop.get(hop.hop, ()):
                        tracer.add(
                            "reduce_leaf", leaf_t, leaf_t + lc.time_s,
                            cat=CAT_COMM, track=f"leaf/{lc.leaf}",
                            clock=MODELED,
                            attrs={"leaf": lc.leaf, "path": lc.path,
                                   "hop": lc.hop, "bytes": lc.bytes,
                                   "time_s": lc.time_s})
                        leaf_t += lc.time_s
                hop_t += hop.time_s
                if tracer:
                    tracer.end(hid, hop_t)
            if tracer:
                tracer.instant("broadcast", hop_t, cat=CAT_COMM,
                               track="round", clock=MODELED,
                               attrs={"s": stage.s})
                tracer.end(rid, hop_t)
            self._modeled_t = hop_t
            self._cum_bytes += self._bytes_per_round or 0
            s_bytes.record(hop_t, float(self._bytes_per_round or 0))
            s_time.record(hop_t, hop_t - t)
            s_cum.record(hop_t, float(self._cum_bytes))

    def _count_stage(self, stage, status):
        """Report one stage's ledger into the obs.metrics registry."""
        m = self.metrics
        m.counter("engine.rounds", unit="rounds",
                  help="communication rounds executed").inc(status.rounds)
        m.counter("engine.iters", unit="iterations",
                  help="local iterations consumed").inc(status.iters)
        m.counter("engine.stages", unit="stages",
                  help="stages executed").inc()
        cb = m.counter("comm.bytes", unit="B",
                       help="modeled payload bytes by hop/reducer")
        ct = m.counter("comm.time_s", unit="s",
                       help="modeled serial α–β link seconds by hop/reducer")
        for hop in self.report.hop_costs:
            cb.inc(status.rounds * hop.bytes, hop=hop.hop,
                   reducer=hop.reducer)
            ct.inc(status.rounds * hop.time_s, hop=hop.hop,
                   reducer=hop.reducer)

    def _record_stage_series(self, stage):
        """Per-stage objective-vs-cumulative-bytes curve: at each stage
        boundary (the modeled cursor), sample the stage-end objective the
        backend published (``train.stage_objective`` gauge) against the
        bytes spent reaching it."""
        self._modeled_series(
            "train.stage_bytes", "B",
            "cumulative modeled payload bytes at each stage boundary"
        ).record(self._modeled_t, float(self._cum_bytes))
        if "train.stage_objective" in self.metrics:
            obj = self.metrics["train.stage_objective"].value(stage=stage.s)
            if obj is not None:
                self._modeled_series(
                    "train.stage_objective", "",
                    "stage-end objective at the modeled stage boundary"
                ).record(self._modeled_t, float(obj))

    # -- run loop -----------------------------------------------------------

    def run(self, backend):
        """Walk the stage stream through ``backend`` and return its native
        result, accumulating the run ledger (rounds, iterations, modeled
        comm bytes/seconds) in ``self.report`` along the way."""
        backend.setup(self)
        if self._bytes_per_round is None:
            raise RuntimeError(
                "backend.setup() must call engine.set_cost_basis()")
        run_attrs = {"algorithm": self.algorithm.name,
                     "topology": type(self.topology).__name__,
                     "backend": type(backend).__name__}
        with self.tracer.span("run", attrs=run_attrs):
            for stage in self.stages:
                with self.tracer.span(
                        "stage", attrs={"s": stage.s, "eta": stage.eta,
                                        "T": stage.T, "k": stage.k}) as sp:
                    status = backend.run_stage(stage, self)
                    sp.set(rounds=status.rounds, iters=status.iters)
                self.trace_rounds(stage, status.rounds)
                self._record_stage_series(stage)
                self.report.stages_run += 1
                self.report.rounds_total += status.rounds
                self.report.iters_total += status.iters
                self.report.comm_bytes_total += status.rounds * self._bytes_per_round
                self.report.comm_time_s += status.rounds * self._time_per_round
                self._count_stage(stage, status)
                log.debug("stage_done", s=stage.s, eta=stage.eta,
                          k=stage.k, rounds=status.rounds,
                          iters=status.iters, stop=status.stop)
                if status.stop:
                    break
            self.report.metrics = self.metrics.snapshot()
            self.report.series = self.series.snapshot()
        return backend.finish(self)
