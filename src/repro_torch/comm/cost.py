"""alpha-beta network cost model for communication rounds.

A round costs ``alpha + bytes / bandwidth``: a fixed latency term (link
setup, stragglers, barrier) plus a serialization term. With it every run
reports *modeled comm-time* next to the comm-round counts of Tables 1-3,
so "fewer rounds" (stagewise k_s) and "cheaper rounds" (compressed
reducers) land in one comparable number.

Byte accounting (star / parameter-server topology, the paper's setting):
  uplink    = n_clients x reducer.message_bytes(template)   (compressed)
  downlink  = n_clients x dense model bytes                 (server broadcast)
Downlink is excluded by default; set ``count_downlink=True`` to include it.

Defaults model a 1 Gbit/s WAN with 5 ms round latency — override per run
via TrainConfig.comm_latency_s / comm_bandwidth_gbps. Calibrated per-hop
link presets belong to the hierarchical topology, which waits for a later
slice of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.utils.tree import tree_leaves


@dataclass(frozen=True)
class NetworkModel:
    """One α–β link: ``latency_s`` is the fixed per-message cost α in
    seconds (setup, barrier), ``bandwidth_gbps`` the serialization rate
    β⁻¹ in Gbit/s. ``count_downlink=True`` additionally bills the dense
    server broadcast (excluded by default: multicast, reducer-independent).
    All times this model produces are modeled seconds, all payloads bytes.
    """

    latency_s: float = 5e-3          # alpha: fixed per-round cost
    bandwidth_gbps: float = 1.0      # beta^-1: link bandwidth, Gbit/s
    count_downlink: bool = False

    @property
    def bandwidth_Bps(self) -> float:
        """Link bandwidth in bytes/second (Gbit/s × 1e9 / 8)."""
        return self.bandwidth_gbps * 1e9 / 8.0

    def time(self, n_bytes: float) -> float:
        """α–β cost in modeled seconds of moving ``n_bytes`` bytes."""
        return self.latency_s + n_bytes / self.bandwidth_Bps


def leaf_elems(leaf) -> int:
    return math.prod(leaf.shape)


def leaf_itemsize(leaf) -> int:
    """Bytes per element of a tensor (or anything with a torch dtype)."""
    return leaf.dtype.itemsize


def dense_bytes(template) -> int:
    """Uncompressed payload of one model replica (the downlink broadcast)."""
    return sum(leaf_elems(l) * leaf_itemsize(l) for l in tree_leaves(template))


def round_bytes(reducer, template, n_clients: int,
                model: NetworkModel | None = None) -> int:
    """Modeled payload bytes one communication round moves: ``n_clients``
    compressed uplink messages (``reducer.message_bytes``, bytes), plus
    — only when the model counts it — the dense downlink broadcast."""
    model = model or NetworkModel()
    up = n_clients * reducer.message_bytes(template)
    if model.count_downlink:
        up += n_clients * dense_bytes(template)
    return up


def round_time(model: NetworkModel, n_bytes: int) -> float:
    """Serial α–β cost in modeled seconds of one round carrying
    ``n_bytes`` bytes: one latency α plus serialization at β."""
    return model.latency_s + n_bytes / model.bandwidth_Bps


def comm_summary_for(cfg, template, n_clients: int, n_rounds: int) -> dict:
    """comm_summary resolved from a TrainConfig's reducer/comm_*/topology
    fields — the one place a finished run's config + round count turns
    into the modeled comm report."""
    from repro_torch.engine.engine import topology_for

    topo = topology_for(cfg)
    return comm_summary(topo.reducer, template, n_clients, n_rounds,
                        topo.network)


def comm_summary(reducer, template, n_clients: int, n_rounds: int,
                 model: NetworkModel | None = None) -> dict:
    """Full comm-cost report for a finished run.

    Also publishes the report's totals as ``comm.summary_*`` gauges in the
    ``repro_torch.obs`` metrics registry (labelled by reducer).
    """
    from repro_torch.obs import metrics as obs_metrics

    model = model or NetworkModel()
    per_round = round_bytes(reducer, template, n_clients, model)
    t_round = round_time(model, per_round)
    m = obs_metrics.registry()
    m.gauge("comm.summary_bytes", unit="B",
            help="total modeled payload bytes of the summarized run").set(
                int(per_round) * int(n_rounds), reducer=reducer.name)
    m.gauge("comm.summary_time_s", unit="s",
            help="total modeled serial α–β seconds of the summarized "
                 "run").set(t_round * int(n_rounds), reducer=reducer.name)
    return {
        "reducer": reducer.name,
        "rounds": int(n_rounds),
        "bytes_per_round": int(per_round),
        "total_bytes": int(per_round) * int(n_rounds),
        "round_time_s": t_round,
        "total_time_s": t_round * int(n_rounds),
        "latency_s": model.latency_s,
        "bandwidth_gbps": model.bandwidth_gbps,
    }
