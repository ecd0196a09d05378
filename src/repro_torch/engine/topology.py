"""Topology — *where* a communication round's bytes travel.

A topology composes reducers over hops and prices each hop with its own
α–β ``NetworkModel``:

  Star           the paper's setting: every client uplinks to one server
                 over a single link (one hop, one reducer).
  StreamingStar  the same hop, reduced leaf by leaf in reverse-layer order
                 (the streaming round); results equal Star's exactly.
  Hierarchical   pod/WAN deployment: an intra-pod reduce over a fast link
                 followed by a (typically compressed) inter-pod reduce over
                 the slow WAN. Clients split into ``n_pods`` equal pods on
                 the leading replica axis; pod reductions run in parallel,
                 so the intra hop's modeled time uses one pod's bytes while
                 its byte count is the total traffic.

Topologies expose the ``init_state`` / ``reduce`` protocol of a
``comm.Reducer``, so the round function does not care which it holds, and
``hop_costs`` prices the round hop by hop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.comm.cost import (NetworkModel, dense_bytes, link_model,
                                   round_time)
from repro_torch.comm.reducer import (DenseMean, Reducer, get_reducer,
                                      reduce_streaming, supports_leaf_bytes)
from repro_torch.comm.shards import over
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_path,
                                    tree_leaves, tree_map)


@dataclass(frozen=True)
class HopCost:
    """Modeled cost of one hop of one communication round."""

    hop: str            # "uplink" | "intra_pod" | "inter_pod" | "downlink"
    reducer: str
    network: NetworkModel
    bytes: int          # total traffic crossing the hop per round
    time_s: float       # α + serial_bytes / bandwidth (parallel links once)


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
                    mult: int, tmult: Optional[int] = None) -> List[LeafCost]:
    """One hop's LeafCost rows from per-leaf message bytes: ``mult``
    messages' worth of traffic per leaf, timed as ``tmult`` (default
    ``mult``) messages' serialization — they differ only for parallel
    intra-pod links, where the hop's byte count is the total traffic but
    its time sees one pod's. The hop latency α goes to the first leaf
    once."""
    tmult = mult if tmult is None else tmult
    out = []
    for i, (b, p) in enumerate(zip(leaf_bytes, paths)):
        t = tmult * b / net.bandwidth_Bps
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
        """Total serial α–β time of one round across all hops (parallel
        intra-pod links are priced once)."""
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


@dataclass(frozen=True)
class Hierarchical(Topology):
    """Two-level pod topology: intra-pod reduce (fast link), then inter-pod
    reduce over the pod means (slow link).

    The client axis must be divisible by ``n_pods``; pod p's replicas are
    the contiguous rows [p·m, (p+1)·m) of the leading client axis. Both
    levels keep their own reducer state (error-feedback residuals live
    per level), so a dense fast-link average composes with an int8-EF WAN
    round. Per-round rng: pod p's intra reduce folds ``rng.fold_in(p)``,
    the inter reduce ``rng.fold_in(n_pods)``.

    Dense∘dense: with ``DenseMean`` on both hops the two-level round is
    the flat mean over all clients (equal-size pods), so it is computed as
    exactly that, with ``DenseMean``'s op — equal to ``Star``'s result bit
    for bit; the cost model still prices both hops. A dense intra hop is
    one fused per-pod mean (a reshaped mean), its state passed through.

    ``streaming=True`` runs the two-level round *per leaf* in
    reverse-layer order: leaf l's intra-pod reduce feeds its inter-pod
    reduce at once. Each hop folds ``.fold_in(leaf)`` under the key the
    blocking round gives it, so results equal the blocking round's
    exactly; the cost model is inherited unchanged. At ``n_pods=1``
    ``get_topology`` resolves the spec to ``Star`` / ``StreamingStar``.

    The port's reducers get views of the stacked replicas (a pod is a
    row range of each leaf); no reducer keeps a view in its state — the
    compressed reducers form a new delta block and a new consensus — so
    writing the consensus back into the replicas leaves the state intact.

    On a device mesh (``shards=``, one ``comm.shards.LeafShards`` per leaf
    over the (pod, data) client grid) the intra hop is the intra reducer's
    round over ``data`` (a dense all-reduce, or a compressed round on the
    rank's pod's clients, its state the rank's own pod's) and the inter
    hop the inter reducer's round over ``pod``, each rank holding its
    pod's mean.
    """

    n_pods: int = 2
    intra: Reducer = field(default_factory=DenseMean)
    inter: Reducer = field(default_factory=DenseMean)
    intra_net: NetworkModel = field(default_factory=lambda: link_model("ici"))
    inter_net: NetworkModel = field(default_factory=lambda: link_model("wan"))
    streaming: bool = False

    @property
    def name(self) -> str:
        return "streaming-hier" if self.streaming else "hierarchical"

    @property
    def all_dense(self) -> bool:
        """True when both hops are DenseMean — the collapsible case."""
        return (type(self.intra) is DenseMean
                and type(self.inter) is DenseMean)

    def _check_pods(self, n_clients: int):
        if n_clients % self.n_pods:
            raise ValueError(
                f"{n_clients} clients not divisible into {self.n_pods} pods")

    def _pods(self, stacked):
        """Pod p's replicas: row views [p·m, (p+1)·m) of every leaf."""
        P = self.n_pods
        return [tree_map(lambda x: x[p * (x.shape[0] // P):
                                     (p + 1) * (x.shape[0] // P)], stacked)
                for p in range(P)]

    def _pod_mean(self, x):
        """Dense intra hop of one leaf as one reshaped mean:
        (N, ...) -> (n_pods, ...)."""
        P = self.n_pods
        return torch.mean(x.reshape((P, x.shape[0] // P) + x.shape[1:]),
                          dim=1)

    def init_state(self, stacked, shards=None):
        if shards is not None:
            n = shards[0].shape[0]
            self._check_pods(n)
            P = self.n_pods
            leaves, treedef = tree_flatten(stacked)
            pods = self._mesh_pods(shards)
            means = [sh.clients.mean(x)[None] for x, sh in zip(leaves, pods)]
            intra = ((None,) * P if type(self.intra) is DenseMean
                     else self.intra.init_state(stacked, pods))
            return {"intra": intra,
                    "inter": self.inter.init_state(
                        treedef.unflatten(means),
                        [over(sh, ("pod",), P) for sh in shards])}
        self._check_pods(tree_leaves(stacked)[0].shape[0])
        return {"intra": tuple(self.intra.init_state(p)
                               for p in self._pods(stacked)),
                "inter": self.inter.init_state(
                    tree_map(self._pod_mean, stacked))}

    def _mesh_pods(self, shards):
        """Each leaf seen as its pod's m = n / n_pods clients over
        ``data`` (the intra hop's ``LeafShards``)."""
        n = shards[0].shape[0]
        return [over(sh, ("data",), n // self.n_pods) for sh in shards]

    def _reduce_on_mesh(self, stacked, state, rng, shards):
        """Each rank's block: the intra hop over ``data`` (its pod's
        clients), then the inter reducer over ``pod`` (per leaf, in
        reverse-layer order when streaming: the same numbers). A
        compressed intra hop's state is the rank's own pod's, its key
        ``rng.fold_in(pod)``, as pod p folds it on one device."""
        if self.all_dense:
            return DenseMean().reduce(stacked, state, rng, shards)
        P = self.n_pods
        self._check_pods(shards[0].shape[0])
        leaves, treedef = tree_flatten(stacked)
        pods = self._mesh_pods(shards)
        dense_intra = type(self.intra) is DenseMean
        if not dense_intra:
            intra_states = self.intra.split_state(state["intra"], treedef)
            pod_key = rng.fold_in(shards[0].clients.mesh.get_local_rank("pod"))
        inter_states = self.inter.split_state(state["inter"], treedef)
        key = rng.fold_in(P)
        out = [None] * len(leaves)
        order = range(len(leaves))
        for i in (reversed(order) if self.streaming else order):
            if dense_intra:
                pod_mean = pods[i].clients.mean(leaves[i])
            else:
                pod_mean, intra_states[i] = self.intra.reduce_leaf(
                    leaves[i], intra_states[i], pod_key.fold_in(i), pods[i])
            out[i], inter_states[i] = self.inter.reduce_leaf(
                pod_mean[None], inter_states[i], key.fold_in(i),
                over(shards[i], ("pod",), P))
        return treedef.unflatten(out), {
            "intra": (state["intra"] if dense_intra else
                      self.intra.join_state(intra_states, treedef)),
            "inter": self.inter.join_state(inter_states, treedef)}

    def reduce(self, stacked, state, rng, shards=None):
        if shards is not None:
            return self._reduce_on_mesh(stacked, state, rng, shards)
        if self.streaming:
            return self._reduce_streaming(stacked, state, rng)
        if self.all_dense:
            # dense∘dense is the flat mean, computed as DenseMean computes
            # it, so that the two-level round equals Star's exactly
            return DenseMean().reduce(stacked, state, rng)
        if type(self.intra) is DenseMean:
            # stateless, rng-free intra hop: one fused per-pod mean
            stacked_means = tree_map(self._pod_mean, stacked)
            intra_states = state["intra"]
        else:
            means, intra_states = [], []
            for p, pod in enumerate(self._pods(stacked)):
                m, st = self.intra.reduce(pod, state["intra"][p],
                                          rng.fold_in(p))
                means.append(m)
                intra_states.append(st)
            # the pod means per leaf, stacked in pod order
            stacked_means = tree_map(lambda *xs: torch.stack(xs), *means)
            intra_states = tuple(intra_states)
        consensus, inter_state = self.inter.reduce(
            stacked_means, state["inter"], rng.fold_in(self.n_pods))
        return consensus, {"intra": intra_states, "inter": inter_state}

    def _reduce_streaming(self, stacked, state, rng):
        """The per-leaf two-level round, in reverse-layer order. Pod p's
        intra hop of leaf i folds ``rng.fold_in(p).fold_in(i)`` — what
        ``intra.reduce`` folds per leaf under ``rng.fold_in(p)`` — and the
        inter hop ``rng.fold_in(n_pods).fold_in(i)``; the dense-intra and
        dense∘dense cases of the blocking round are kept per leaf."""
        leaves, treedef = tree_flatten(stacked)
        P = self.n_pods
        out = [None] * len(leaves)
        if self.all_dense:
            for i in reversed(range(len(leaves))):
                out[i], _ = DenseMean().reduce_leaf(leaves[i], None, None)
            return treedef.unflatten(out), state
        dense_intra = type(self.intra) is DenseMean
        if not dense_intra:
            intra_states = [self.intra.split_state(state["intra"][p], treedef)
                            for p in range(P)]
            pod_keys = [rng.fold_in(p) for p in range(P)]
        inter_states = self.inter.split_state(state["inter"], treedef)
        inter_key = rng.fold_in(P)
        for i in reversed(range(len(leaves))):
            x = leaves[i]
            if dense_intra:
                pod_means = self._pod_mean(x)
            else:
                m = x.shape[0] // P
                pms = []
                for p in range(P):
                    pm, intra_states[p][i] = self.intra.reduce_leaf(
                        x[p * m:(p + 1) * m], intra_states[p][i],
                        pod_keys[p].fold_in(i))
                    pms.append(pm)
                pod_means = torch.stack(pms)
            out[i], inter_states[i] = self.inter.reduce_leaf(
                pod_means, inter_states[i], inter_key.fold_in(i))
        new_intra = (state["intra"] if dense_intra else
                     tuple(self.intra.join_state(intra_states[p], treedef)
                           for p in range(P)))
        return treedef.unflatten(out), {
            "intra": new_intra,
            "inter": self.inter.join_state(inter_states, treedef)}

    def hop_costs(self, template, n_clients: int) -> List[HopCost]:
        # the shape contract of init_state/reduce: pricing must not succeed
        # for a configuration execution would reject
        self._check_pods(n_clients)
        m = n_clients // self.n_pods
        intra_msg = self.intra.message_bytes(template)
        inter_msg = self.inter.message_bytes(template)
        inter_total = self.n_pods * inter_msg
        hops = [
            # pods reduce in parallel: time sees one pod's traffic
            HopCost(hop="intra_pod", reducer=self.intra.name,
                    network=self.intra_net, bytes=n_clients * intra_msg,
                    time_s=self.intra_net.latency_s
                    + m * intra_msg / self.intra_net.bandwidth_Bps),
            HopCost(hop="inter_pod", reducer=self.inter.name,
                    network=self.inter_net, bytes=inter_total,
                    time_s=self.inter_net.latency_s
                    + inter_total / self.inter_net.bandwidth_Bps),
        ]
        if self.inter_net.count_downlink:
            # the global consensus broadcast rides the slow (WAN) link back
            # to every client — dense and reducer-independent, like Star's
            down = n_clients * dense_bytes(template)
            hops.append(HopCost(hop="downlink", reducer="dense",
                                network=self.inter_net, bytes=down,
                                time_s=round_time(self.inter_net, down)))
        return hops

    def leaf_costs(self, template, n_clients: int) -> List[LeafCost]:
        """Per-leaf ledger across both hops, mirroring ``hop_costs``."""
        self._check_pods(n_clients)
        if not (supports_leaf_bytes(self.intra)
                and supports_leaf_bytes(self.inter)):
            return []
        paths = _leaf_paths(template)
        out = _hop_leaf_costs("intra_pod",
                              self.intra.leaf_message_bytes(template),
                              paths, self.intra_net, mult=n_clients,
                              tmult=n_clients // self.n_pods)
        out += _hop_leaf_costs("inter_pod",
                               self.inter.leaf_message_bytes(template),
                               paths, self.inter_net, mult=self.n_pods)
        if self.inter_net.count_downlink:
            out += _hop_leaf_costs("downlink",
                                   DenseMean().leaf_message_bytes(template),
                                   paths, self.inter_net, mult=n_clients)
        return out


def get_topology(spec, *, reducer=None, network: NetworkModel | None = None,
                 n_pods: int = 2, inter_reducer=None,
                 quant_bits: int = 8, topk_frac: float = 0.1) -> Topology:
    """Resolve a topology from a config string (or pass one through).

    "star" (default) wraps ``reducer`` in the single-hop paper topology;
    "streaming"/"streaming-star" is the same hop reduced per leaf;
    "hier"/"hierarchical"/"pods" composes ``reducer`` intra-pod with
    ``inter_reducer`` (int8 by default) inter-pod, over the reference's
    ICI preset and ``network`` (default its WAN preset);
    "streaming-hier"/"hier-streaming"/"streaming-hierarchical" is the same
    two-level round reduced per leaf. With ``n_pods=1`` a hierarchical
    spec has no inter-pod link and resolves to ``Star`` (blocking) or
    ``StreamingStar`` (streaming) over ``reducer``.
    """
    if isinstance(spec, Topology):
        return spec
    red = get_reducer(reducer, quant_bits=quant_bits, topk_frac=topk_frac)
    if spec in (None, "star", "flat"):
        return Star(reducer=red, network=network or NetworkModel())
    if spec in ("streaming", "streaming-star", "stream"):
        return StreamingStar(reducer=red, network=network or NetworkModel())
    hier_specs = ("hier", "hierarchical", "pods")
    stream_hier_specs = ("streaming-hier", "hier-streaming",
                         "streaming-hierarchical")
    if spec in hier_specs + stream_hier_specs:
        streaming = spec in stream_hier_specs
        if n_pods == 1:
            cls = StreamingStar if streaming else Star
            return cls(reducer=red, network=network or NetworkModel())
        inter = get_reducer(inter_reducer if inter_reducer is not None
                            else "int8", quant_bits=quant_bits,
                            topk_frac=topk_frac)
        return Hierarchical(n_pods=n_pods, intra=red, inter=inter,
                            intra_net=link_model("ici"),
                            inter_net=network or link_model("wan"),
                            streaming=streaming)
    raise ValueError(f"unknown topology spec: {spec!r}")
