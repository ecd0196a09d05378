"""Topology — *where* a communication round's bytes travel.

A topology composes reducers over hops and prices each hop with its own
α–β ``NetworkModel``:

  Star           the paper's setting: every client uplinks to one server
                 over a single link (one hop, one reducer).
  StreamingStar  the same hop, reduced leaf by leaf in reverse-layer order
                 (the streaming round); results equal Star's exactly.

Topologies expose the ``init_state`` / ``reduce`` protocol of a
``comm.Reducer``, so the round function does not care which it holds, and
``hop_costs`` prices the round hop by hop. The two-level ``Hierarchical``
topology waits for a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.comm.cost import NetworkModel, dense_bytes, round_time
from repro_torch.comm.reducer import (DenseMean, Reducer, get_reducer,
                                      reduce_streaming, supports_leaf_bytes)
from repro_torch.utils.tree import tree_flatten_with_path


@dataclass(frozen=True)
class HopCost:
    """Modeled cost of one hop of one communication round."""

    hop: str            # "uplink" | "downlink"
    reducer: str
    network: NetworkModel
    bytes: int          # total traffic crossing the hop per round
    time_s: float       # α + serial_bytes / bandwidth


@dataclass(frozen=True)
class LeafCost:
    """Modeled cost of ONE leaf's share of one hop of one round.

    ``bytes`` is the total traffic that leaf's messages put on the hop per
    round (all clients), ``time_s`` its share of the hop's serial α–β time
    (the hop latency α is attributed to the hop's first leaf once). Summing
    a hop's LeafCosts reproduces the tree-level ``HopCost`` — bytes exactly,
    seconds to float-sum precision.
    """

    leaf: int           # index into tree_leaves(template)
    path: str           # keystr path of the leaf, as jax.tree_util renders it
    hop: str            # same hop names as HopCost
    bytes: int          # total per-round traffic of this leaf on this hop
    time_s: float       # this leaf's share of the hop's serial α–β time


def _leaf_paths(template) -> List[str]:
    """keystr paths for every leaf of a template tree, in leaf order."""
    return [p for p, _ in tree_flatten_with_path(template)[0]]


def _hop_leaf_costs(hop: str, leaf_bytes, paths, net: NetworkModel, *,
                    mult: int) -> List[LeafCost]:
    """One hop's LeafCost rows from per-leaf message bytes: ``mult``
    messages' worth of traffic per leaf; the hop latency α goes to the
    first leaf once."""
    out = []
    for i, (b, p) in enumerate(zip(leaf_bytes, paths)):
        t = mult * b / net.bandwidth_Bps
        if i == 0:
            t += net.latency_s
        out.append(LeafCost(leaf=i, path=p, hop=hop,
                            bytes=mult * b, time_s=t))
    return out


class Topology:
    """Base protocol — reducer-compatible reduce + per-hop costing."""

    name = "base"

    def init_state(self, stacked):
        """Reducer state for the stacked (N, ...) replica tree; call at run
        start when replicas are identical."""
        raise NotImplementedError

    def reduce(self, stacked, state, rng):
        """Route one round: (stacked replicas, state, rng) -> (consensus
        tree without the client axis, new state)."""
        raise NotImplementedError

    def hop_costs(self, template, n_clients: int) -> List[HopCost]:
        """Price one round hop by hop (``template`` is a single replica)."""
        raise NotImplementedError

    def leaf_costs(self, template, n_clients: int) -> List[LeafCost]:
        """Per-(leaf, hop) breakdown of one round's modeled cost (empty for
        a topology without per-leaf accounting)."""
        return []

    def round_bytes(self, template, n_clients: int) -> int:
        """Total modeled payload bytes one round moves across all hops."""
        return sum(h.bytes for h in self.hop_costs(template, n_clients))

    def round_time(self, template, n_clients: int) -> float:
        """Total serial α–β time of one round across all hops."""
        return sum(h.time_s for h in self.hop_costs(template, n_clients))

    def summary(self, template, n_clients: int, n_rounds: int) -> dict:
        """Full per-hop comm report for a finished run."""
        hops = self.hop_costs(template, n_clients)
        per_round = sum(h.bytes for h in hops)
        t_round = sum(h.time_s for h in hops)
        return {
            "topology": self.name,
            "rounds": int(n_rounds),
            "bytes_per_round": int(per_round),
            "total_bytes": int(per_round) * int(n_rounds),
            "round_time_s": t_round,
            "total_time_s": t_round * int(n_rounds),
            "hops": [{
                "hop": h.hop, "reducer": h.reducer,
                "latency_s": h.network.latency_s,
                "bandwidth_gbps": h.network.bandwidth_gbps,
                "bytes_per_round": int(h.bytes),
                "time_per_round_s": h.time_s,
                "total_time_s": h.time_s * int(n_rounds),
            } for h in hops],
        }


@dataclass(frozen=True)
class Star(Topology):
    """Flat parameter-server topology — the paper's setting, one hop."""

    reducer: Reducer = field(default_factory=DenseMean)
    network: NetworkModel = field(default_factory=NetworkModel)

    name = "star"

    def init_state(self, stacked):
        return self.reducer.init_state(stacked)

    def reduce(self, stacked, state, rng):
        return self.reducer.reduce(stacked, state, rng)

    def hop_costs(self, template, n_clients: int) -> List[HopCost]:
        up = n_clients * self.reducer.message_bytes(template)
        hops = [HopCost(hop="uplink", reducer=self.reducer.name,
                        network=self.network, bytes=up,
                        time_s=round_time(self.network, up))]
        if self.network.count_downlink:
            # the dense server broadcast is its own hop, billed only on
            # count_downlink links
            down = n_clients * dense_bytes(template)
            hops.append(HopCost(hop="downlink", reducer="dense",
                                network=self.network, bytes=down,
                                time_s=round_time(self.network, down)))
        return hops

    def leaf_costs(self, template, n_clients: int) -> List[LeafCost]:
        if not supports_leaf_bytes(self.reducer):
            return []
        leaf_bytes = self.reducer.leaf_message_bytes(template)
        paths = _leaf_paths(template)
        out = _hop_leaf_costs("uplink", leaf_bytes, paths, self.network,
                              mult=n_clients)
        if self.network.count_downlink:
            down = DenseMean().leaf_message_bytes(template)
            out += _hop_leaf_costs("downlink", down, paths, self.network,
                                   mult=n_clients)
        return out


@dataclass(frozen=True)
class StreamingStar(Star):
    """Star whose reduce runs *per leaf* in reverse-layer order — the
    streaming round. Each leaf folds the same per-leaf rng the tree-level
    reducer folds, so results equal Star's exactly; the cost model is
    inherited unchanged."""

    name = "streaming-star"

    def reduce(self, stacked, state, rng):
        return reduce_streaming(self.reducer, stacked, state, rng)


def get_topology(spec, *, reducer=None, network: NetworkModel | None = None,
                 quant_bits: int = 8, topk_frac: float = 0.1) -> Topology:
    """Resolve a topology from a config string (or pass one through).

    "star" (default) wraps ``reducer`` in the single-hop paper topology;
    "streaming"/"streaming-star" is the same hop reduced per leaf.
    """
    if isinstance(spec, Topology):
        return spec
    if spec in ("hier", "hierarchical", "pods", "streaming-hier",
                "hier-streaming", "streaming-hierarchical"):
        raise NotImplementedError(
            f"topology {spec!r}: the hierarchical topology comes with a "
            f"later slice of the port (ROADMAP queue 1: Hierarchical)")
    red = get_reducer(reducer, quant_bits=quant_bits, topk_frac=topk_frac)
    if spec in (None, "star", "flat"):
        return Star(reducer=red, network=network or NetworkModel())
    if spec in ("streaming", "streaming-star", "stream"):
        return StreamingStar(reducer=red, network=network or NetworkModel())
    raise ValueError(f"unknown topology spec: {spec!r}")
