"""Reducer protocol — pluggable compression for the communication round.

A *reducer* owns Algorithm 1 line 5 (the parameter average). Compressed
reducers follow the error-feedback template over *round deltas*: every
client starts the round at the shared consensus ``ref``; after its k local
steps it uploads

    m_i = C((x_i - ref) + e_i)          (compress delta + carried residual)
    e_i' = (x_i - ref) + e_i - m_i      (what the compressor dropped)

and the server forms the next consensus ``ref' = ref + mean_i m_i``.

Reducers are functions of (stacked replicas, state, rng) on dict/list
trees of tensors; the state keeps one tree structure across calls. On a
device mesh they take each leaf's ``comm.shards.LeafShards`` and run on
the rank's block of it: the dense mean all-reduced over the client axes,
int8 codes and scales all-gathered over them, a top-k round's candidates
all-gathered over the mesh dims that split the leaf (``shards=``).
``rng`` is a key (``utils.rng``): the reducer folds the leaf index into
it and draws the leaf's stochastic-rounding bits from the result, as the
JAX package folds ``fold_in(rng, i)``.

Implementations
  DenseMean     — identity compression; the plain mean.
  QuantizedMean — int8 (or narrower) symmetric stochastic-rounding delta
                  quantization per (client, leaf), through the Hopper
                  quantize / dequant_mean kernels on CUDA tensors and their
                  plain versions on CPU tensors.
  TopKMean      — magnitude top-k delta sparsification per (client, leaf),
                  ties to the lower flat index (``top_mask``).
  StalenessWeightedMean — merge-on-arrival for asynchronous rounds
                  (``runtime``): one client's message at a time, dense or
                  int<b> (the quantize kernels on a one-row block per leaf).

``message_bytes(template)`` reports the compressed uplink payload one
client sends per round — the quantity comm.cost prices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.comm.cost import leaf_elems, leaf_itemsize
from repro_torch.kernels.quantize import ops as Q
from repro_torch.obs import metrics as obs_metrics
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map


class Reducer:
    """Base protocol. Subclasses override the tree-level ``reduce()`` and the
    per-leaf byte accounting (``leaf_message_bytes``); the per-leaf reduce
    protocol (``split_state`` / ``reduce_leaf`` / ``join_state``) is what
    the streaming round (``engine.StreamingStar``) drives — leaf by leaf,
    same numerics as the tree-level call."""

    name = "base"

    def init_state(self, stacked, shards=None):
        """Residual/reference state for the stacked (N, ...) replica tree
        (on a mesh, ``shards``: this rank's blocks).

        Call at run start, when all replicas are identical.
        """
        return None

    def reduce(self, stacked, state, rng, shards=None):
        """(stacked replicas, state, rng) -> (consensus tree, new state).

        The consensus tree has the leading client axis removed; callers
        rebroadcast it to continue local training. ``shards``: on a mesh,
        one ``LeafShards`` per leaf, the replicas and state being the
        rank's blocks.
        """
        leaves, treedef = tree_flatten(stacked)
        states = self.split_state(state, treedef)
        shards = shards or [None] * len(leaves)
        means, new_states = [], []
        for i, (x, st, sh) in enumerate(zip(leaves, states, shards)):
            consensus, ns = self.reduce_leaf(x, st, rng.fold_in(i), sh)
            means.append(consensus)
            new_states.append(ns)
        return treedef.unflatten(means), self.join_state(new_states, treedef)

    # -- per-leaf protocol (streaming reduce) -------------------------------

    def split_state(self, state, treedef):
        """Split the reducer state into one per-leaf slice, index-aligned
        with the stacked tree's leaves. Stateless reducers yield None."""
        return [None] * treedef.num_leaves

    def join_state(self, leaf_states, treedef):
        """Inverse of ``split_state``: rebuild the tree-level state."""
        return None

    def reduce_leaf(self, x, leaf_state, rng, shards=None):
        """Reduce ONE stacked (N, ...) leaf -> (consensus leaf, new state).

        Leaves are independent, so calling this per leaf — in any order,
        with the same per-leaf rng the tree-level ``reduce`` folds — gives
        the tree-level result exactly.
        """
        raise NotImplementedError

    # -- byte accounting ----------------------------------------------------

    def leaf_message_bytes(self, template) -> list:
        """Per-leaf compressed uplink payload, in bytes, one client sends
        per round — index-aligned with ``tree_leaves(template)``."""
        raise NotImplementedError

    def message_bytes(self, template) -> int:
        """Total compressed uplink bytes one client sends per round."""
        return sum(self.leaf_message_bytes(template))

    def __repr__(self):
        return f"{type(self).__name__}()"


@dataclass(frozen=True, repr=False)
class DenseMean(Reducer):
    """Uncompressed average."""

    name = "dense"

    def reduce(self, stacked, state, rng, shards=None):
        if shards is not None:
            return super().reduce(stacked, state, rng, shards)
        return tree_map(lambda x: torch.mean(x, dim=0), stacked), state

    def reduce_leaf(self, x, leaf_state, rng, shards=None):
        """The same op as the tree-level mean, so per-leaf streaming gives
        the tree-level result exactly."""
        if shards is not None:
            return shards.clients.mean(x), leaf_state
        return torch.mean(x, dim=0), leaf_state

    def leaf_message_bytes(self, template) -> list:
        """Raw leaf payloads: elements × itemsize bytes per leaf."""
        return [leaf_elems(l) * leaf_itemsize(l)
                for l in tree_leaves(template)]


class _DeltaReducer(Reducer):
    """Shared error-feedback-over-deltas machinery for compressed reducers.

    Subclasses implement ``_compress(y, rng, shards) -> (deq, mean)`` on
    an (N, M) float32 block of per-client deltas: ``deq`` is each client's
    decompressed message (N, M), ``mean`` its average (M,); on a mesh the
    block is the rank's (N_local, M_local) and ``mean`` the average over
    all N clients of its M_local elements.
    """

    error_feedback: bool = True

    def init_state(self, stacked, shards=None):
        """On a mesh (``shards``) ``ref`` is client 0's block, gathered
        from the rank that holds it."""
        if shards is None:
            first = tree_map(lambda x: x[0], stacked)
        else:
            leaves, treedef = tree_flatten(stacked)
            first = treedef.unflatten([sh.clients.gather(x[:1])[0]
                                       for x, sh in zip(leaves, shards)])
        return {
            # ref: the shared consensus every client started the round from
            "ref": tree_map(lambda x: x.to(torch.float32).clone(), first),
            # res: per-client residual the compressor dropped so far
            "res": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                  device=x.device), stacked),
        }

    def split_state(self, state, treedef):
        refs = treedef.flatten_up_to(state["ref"])
        res = treedef.flatten_up_to(state["res"])
        return [{"ref": r, "res": e} for r, e in zip(refs, res)]

    def join_state(self, leaf_states, treedef):
        return {"ref": treedef.unflatten([s["ref"] for s in leaf_states]),
                "res": treedef.unflatten([s["res"] for s in leaf_states])}

    def reduce_leaf(self, x, leaf_state, rng, shards=None):
        """One leaf's EF round: compress (delta + residual), average, carry
        the compression error forward."""
        r, e = leaf_state["ref"], leaf_state["res"]
        n = x.shape[0]
        y = (x.to(torch.float32).reshape(n, -1)
             - r.reshape(1, -1) + e.reshape(n, -1))
        deq, mean_delta = self._compress(y, rng, shards)
        consensus = r.reshape(-1) + mean_delta
        drop = (y - deq) if self.error_feedback else torch.zeros_like(y)
        return (consensus.reshape(r.shape).to(x.dtype),
                {"ref": consensus.reshape(r.shape),
                 "res": drop.reshape(e.shape)})



@dataclass(frozen=True, repr=False)
class QuantizedMean(_DeltaReducer):
    """Symmetric stochastic-rounding delta quantization with error feedback.

    Per (client, leaf): scale = max|delta|, codes = SR(delta/scale * qmax)
    in ``bits``-bit signed range (stored int8). ``error_feedback=False``
    gives the naive quantizer (ablations); ``stochastic=False`` rounds to
    nearest (u = 0.5 constant).
    """

    bits: int = 8
    error_feedback: bool = True
    stochastic: bool = True

    @property
    def name(self):
        return f"int{self.bits}" + ("" if self.error_feedback else "-noef")

    def _compress(self, y, rng, shards=None):
        scales = Q.compute_scale(y, dim=1)
        if shards is not None:
            # the scale is the max over the whole leaf of each client
            scales = shards.replica_max(scales)
        if not self.stochastic:
            # 1 << 31 as a uint32 word (u = 0.5), carried as int32
            rbits = torch.full(y.shape, -2 ** 31, dtype=torch.int32,
                               device=y.device)
        elif shards is not None:
            rbits = shards.local_bits(rng)
        else:
            rbits = rng.bits(y.shape)
        q = Q.encode_leaf(y, rbits, scales, bits=self.bits)
        if shards is None:
            return Q.decode_mean_leaf(q, scales, bits=self.bits)
        # every client's codes and scales, in client order: each rank
        # averages its M_local columns over all N clients
        deq = q.to(torch.float32) * (scales[:, None] / Q.qmax_for(self.bits))
        mean = Q.dequant_mean(shards.clients.gather(q),
                              shards.clients.gather(scales), bits=self.bits)
        return deq, mean

    def leaf_message_bytes(self, template) -> list:
        # bits-wide codes (packed) + one f32 scale per leaf
        return [-(-leaf_elems(l) * self.bits // 8) + 4
                for l in tree_leaves(template)]


@dataclass(frozen=True, repr=False)
class TopKMean(_DeltaReducer):
    """Magnitude top-k delta sparsification with error feedback.

    Per (client, leaf): keep the k = max(1, round(frac * size)) largest-
    magnitude delta entries; the rest accumulate into the residual.
    Messages are (f32 value, i32 index) pairs.
    """

    frac: float = 0.1
    error_feedback: bool = True

    @property
    def name(self):
        return f"top{self.frac:g}" + ("" if self.error_feedback else "-noef")

    def _k(self, size: int) -> int:
        return max(1, min(size, int(round(self.frac * size))))

    def _compress(self, y, rng, shards=None):
        """On a mesh the k is the whole leaf's and so is the selection
        (``top_mask``); ``mean`` is the float32 sum over all clients
        all-reduced over the client axes, times 1/N, as the reference
        writes it."""
        if shards is None:
            keep = top_mask(torch.abs(y), self._k(y.shape[1]))
            deq = torch.where(keep, y, 0.0)
            return deq, torch.sum(deq, dim=0) * (1.0 / y.shape[0])
        size = math.prod(shards.shape[1:])
        keep = top_mask(torch.abs(y), self._k(size), shards)
        deq = torch.where(keep, y, 0.0)
        return deq, shards.clients.sum(deq) * (1.0 / shards.clients.n_clients)

    def leaf_message_bytes(self, template) -> list:
        # (f32 value + i32 index) per kept entry
        return [8 * self._k(leaf_elems(l)) for l in tree_leaves(template)]


@dataclass(frozen=True, repr=False)
class StalenessWeightedMean(_DeltaReducer):
    """Merge-on-arrival reducer for asynchronous rounds (``runtime``).

    Each client uploads an (optionally int<b>-quantized, through the same
    kernels as ``QuantizedMean``) error-feedback-corrected round delta,
    and the server applies messages *as they arrive*:

        server' = server + w(τ)/N · deq(C(Δ_i + e_i))
        w(τ)    = (1 + τ)^(-decay)

    where the staleness τ counts server cycles beyond the natural pipeline
    lag, τ = max(0, merges_since_pull − (N−1)) / N, as the runtime reports
    it. The synchronous ``reduce`` over a stacked cohort (all clients at
    τ = 0) is inherited, so the topology and cost plumbing prices it like
    any other reducer; ``encode`` / ``merge`` are what the runtime drives.
    """

    decay: float = 0.5
    compress: str = "dense"   # "dense" | "int" (bits-wide quantization)
    bits: int = 8
    error_feedback: bool = True

    @property
    def name(self):
        tag = "" if self.compress == "dense" else f"-int{self.bits}"
        return f"staleness{tag}"

    def weight(self, staleness: float) -> float:
        """Merge weight for a message that is ``staleness`` cycles late."""
        return (1.0 + max(0.0, float(staleness))) ** (-self.decay)

    def _compress(self, y, rng, shards=None):
        if shards is not None:
            raise NotImplementedError("asynchronous rounds run on one "
                                      "device")
        if self.compress == "dense":
            return y, torch.mean(y, dim=0)
        return QuantizedMean(bits=self.bits)._compress(y, rng)

    # -- per-message async protocol (driven by runtime) ---------------------

    def client_residual(self, template):
        """Fresh per-client error-feedback residual (float32 zeros tree)."""
        return tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                              device=l.device), template)

    def encode(self, delta, residual, rng):
        """One client's upload: compress (Δ + e), each leaf as a one-row
        (1, M) block (under int<b>: one quantize and one dequant_mean
        launch per leaf on CUDA).

        Returns (payload, residual'): the decompressed float32 delta tree
        the server applies, and what the compressor dropped (zeros when
        error feedback is off). Every returned tensor is new.
        """
        leaves, treedef = tree_flatten(delta)
        res = treedef.flatten_up_to(residual)
        payloads, new_res = [], []
        for i, (d, e) in enumerate(zip(leaves, res)):
            y = (d.to(torch.float32) + e).reshape(1, -1)
            deq, _ = self._compress(y, rng.fold_in(i))
            p = deq.reshape(d.shape)
            payloads.append(p)
            new_res.append((y.reshape(e.shape) - p) if self.error_feedback
                           else torch.zeros_like(e))
        m = obs_metrics.registry()
        m.counter("comm.messages", unit="messages",
                  help="async client uploads encoded").inc(
                      reducer=self.name)
        m.counter("comm.message_bytes", unit="B",
                  help="compressed payload bytes of async uploads").inc(
                      sum(self.leaf_message_bytes(delta)),
                      reducer=self.name)
        return treedef.unflatten(payloads), treedef.unflatten(new_res)

    def merge(self, server, payload, staleness: float, n_clients: int):
        """Apply one arrived message to the server model. Returns a new
        tree: the server's tensors are never written in place, so a tree a
        client pulled earlier keeps its values."""
        w = self.weight(staleness) / float(n_clients)
        obs_metrics.registry().histogram(
            "comm.merge_weight", unit="weight",
            help="staleness-decayed merge weights w(τ)/N applied").observe(
                w, reducer=self.name)
        return tree_map(lambda s, p: s + w * p.to(s.dtype), server, payload)

    def leaf_message_bytes(self, template) -> list:
        if self.compress == "dense":
            return [leaf_elems(l) * 4 for l in tree_leaves(template)]
        return [-(-leaf_elems(l) * self.bits // 8) + 4
                for l in tree_leaves(template)]


def top_mask(a, k: int, shards=None):
    """Each row's k largest of the (n, M) magnitudes ``a``, as a bool mask,
    the lower flat index first among equal magnitudes (``jax.lax.top_k``'s
    rule).

    The row's k-th largest t is found once (``torch.topk``, unsorted);
    every element above t is kept, and of the elements equal to t the
    first ``need`` in row order (``_first_ties``): k less those above t
    on one device.

    On a mesh (``shards``, a leaf split over ``shards.split_axes``) the
    rank's block holds part of each row. Each rank offers its own
    min(k, M_local) best, by the same rule, as candidates: their
    magnitudes and flat indices in the leaf, padded to k with -1 and
    all-gathered over the split axes. The leaf's k best are among them
    (a rank's winners are a prefix of its own order). t and the flat index
    of the last tied winner come from the candidates, and the rank keeps
    its own tied candidates up to that index. A leaf that is not split
    takes the one-device code.
    """
    if shards is None or not shards.split_axes:
        t = _kth(a, k)
        above = a > t
        return _first_ties(above, a == t,
                           k - above.sum(dim=1, keepdim=True))
    n, kl = a.shape[0], min(k, a.shape[1])
    pos = top_mask(a, kl).nonzero()[:, 1].view(n, kl)   # row order
    vals = torch.gather(a, 1, pos)
    idx = shards.flat_index(pos)
    if kl < k:
        vals = torch.cat([vals, vals.new_full((n, k - kl), -1.0)], dim=1)
        idx = torch.cat([idx, idx.new_full((n, k - kl), -1)], dim=1)
    all_vals, all_idx = shards.gather_split(vals), shards.gather_split(idx)
    t = _kth(all_vals, k)
    need = k - (all_vals > t).sum(dim=1, keepdim=True)
    tied = torch.where(all_vals == t, all_idx, torch.iinfo(torch.int64).max)
    last = torch.sort(tied, dim=1).values.gather(1, need - 1)
    return _first_ties(a > t, a == t, ((vals == t) & (idx <= last)).sum(
        dim=1, keepdim=True))


def _kth(a, k: int):
    """Each row's k-th largest, as an (n, 1) column."""
    return torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1,
                                                             keepdim=True)


def _first_ties(above, tied, need):
    """The mask ``above`` and of each row's first ``need`` elements of
    ``tied``, in row order."""
    # one scan a row: a row alone takes the device's one-dim scan, a batch
    # of few long rows scans each row with one thread block (two rows of
    # qwen3-14b's embedding leaf on an H100: 10.4 ms a row at a time,
    # 1,178 ms batched)
    rank = torch.empty(tied.shape, dtype=torch.int32, device=tied.device)
    for r in range(tied.shape[0]):
        torch.cumsum(tied[r], dim=0, dtype=torch.int32, out=rank[r])
    return above | (tied & (rank <= need))


def supports_leaf_bytes(reducer: Reducer) -> bool:
    """True iff ``reducer`` overrides ``leaf_message_bytes`` — the per-leaf
    ledger branches on this probe instead of catching NotImplementedError,
    so a bug inside an implemented per-leaf method propagates."""
    return type(reducer).leaf_message_bytes is not Reducer.leaf_message_bytes


def reduce_streaming(reducer: Reducer, stacked, state, rng, shards=None):
    """One streaming round: reduce the stacked replica tree leaf by leaf.

    Leaves run in *reverse-layer order* — the order they finish their
    last local step under backprop — and each leaf folds the same per-leaf
    rng the tree-level ``reducer.reduce`` folds (``rng.fold_in(i)``), so
    the result equals the blocking round's exactly. Returns
    ``(consensus tree, new state)`` like ``Reducer.reduce``.
    """
    leaves, treedef = tree_flatten(stacked)
    states = reducer.split_state(state, treedef)
    shards = shards or [None] * len(leaves)
    out = [None] * len(leaves)
    new = [None] * len(leaves)
    for i in reversed(range(len(leaves))):
        out[i], new[i] = reducer.reduce_leaf(leaves[i], states[i],
                                             rng.fold_in(i), shards[i])
    return treedef.unflatten(out), reducer.join_state(new, treedef)


def get_reducer(spec, *, quant_bits: int = 8, topk_frac: float = 0.1,
                staleness_decay: float = 0.5) -> Reducer:
    """Resolve a reducer from a config string (or pass a Reducer through).

    Accepted specs: "dense" | "int8" / "quant" (quant_bits-wide) |
    "int<b>" (explicit width) | "topk" (topk_frac) |
    "staleness" / "staleness-int<b>" (async merge-on-arrival weights).
    """
    if isinstance(spec, Reducer):
        return spec
    if spec in (None, "dense", "mean"):
        return DenseMean()
    if spec in ("quant", "int8", "quantized"):
        b = 8 if spec == "int8" else quant_bits
        return QuantizedMean(bits=b)
    if spec == "staleness":
        return StalenessWeightedMean(decay=staleness_decay)
    if spec.startswith("staleness-int"):
        return StalenessWeightedMean(decay=staleness_decay, compress="int",
                                     bits=int(spec[len("staleness-int"):]))
    if spec.startswith("int"):
        return QuantizedMean(bits=int(spec[3:]))
    if spec == "topk":
        return TopKMean(frac=topk_frac)
    raise ValueError(f"unknown reducer spec: {spec!r}")
