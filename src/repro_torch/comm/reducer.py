"""Reducer protocol — pluggable compression for the communication round.

A *reducer* owns Algorithm 1 line 5 (the parameter average). Compressed
reducers follow the error-feedback template over *round deltas*: every
client starts the round at the shared consensus ``ref``; after its k local
steps it uploads

    m_i = C((x_i - ref) + e_i)          (compress delta + carried residual)
    e_i' = (x_i - ref) + e_i - m_i      (what the compressor dropped)

and the server forms the next consensus ``ref' = ref + mean_i m_i``.

Reducers are functions of (stacked replicas, state, rng) on dict/list
trees of tensors; the state keeps one tree structure across calls.
``rng`` is a key (``utils.rng``): the reducer folds the leaf index into
it and draws the leaf's stochastic-rounding bits from the result, as the
JAX package folds ``fold_in(rng, i)``.

Implementations
  DenseMean     — identity compression; the plain mean.
  QuantizedMean — int8 (or narrower) symmetric stochastic-rounding delta
                  quantization per (client, leaf), through the Hopper
                  quantize / dequant_mean kernels on CUDA tensors and their
                  plain versions on CPU tensors.
  TopKMean      — magnitude top-k delta sparsification per (client, leaf).

``message_bytes(template)`` reports the compressed uplink payload one
client sends per round — the quantity comm.cost prices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.comm.cost import leaf_elems, leaf_itemsize
from repro_torch.kernels.quantize import ops as Q
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map


class Reducer:
    """Base protocol. Subclasses override the tree-level ``reduce()`` and the
    per-leaf byte accounting (``leaf_message_bytes``); the per-leaf reduce
    protocol (``split_state`` / ``reduce_leaf`` / ``join_state``) is what
    the streaming round (``engine.StreamingStar``) drives — leaf by leaf,
    same numerics as the tree-level call."""

    name = "base"

    def init_state(self, stacked):
        """Residual/reference state for the stacked (N, ...) replica tree.

        Call at run start, when all replicas are identical.
        """
        return None

    def reduce(self, stacked, state, rng):
        """(stacked replicas, state, rng) -> (consensus tree, new state).

        The consensus tree has the leading client axis removed; callers
        rebroadcast it to continue local training.
        """
        raise NotImplementedError

    # -- per-leaf protocol (streaming reduce) -------------------------------

    def split_state(self, state, treedef):
        """Split the reducer state into one per-leaf slice, index-aligned
        with the stacked tree's leaves. Stateless reducers yield None."""
        return [None] * treedef.num_leaves

    def join_state(self, leaf_states, treedef):
        """Inverse of ``split_state``: rebuild the tree-level state."""
        return None

    def reduce_leaf(self, x, leaf_state, rng):
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

    def reduce(self, stacked, state, rng):
        return tree_map(lambda x: torch.mean(x, dim=0), stacked), state

    def reduce_leaf(self, x, leaf_state, rng):
        """The same op as the tree-level mean, so per-leaf streaming gives
        the tree-level result exactly."""
        return torch.mean(x, dim=0), leaf_state

    def leaf_message_bytes(self, template) -> list:
        """Raw leaf payloads: elements × itemsize bytes per leaf."""
        return [leaf_elems(l) * leaf_itemsize(l)
                for l in tree_leaves(template)]


class _DeltaReducer(Reducer):
    """Shared error-feedback-over-deltas machinery for compressed reducers.

    Subclasses implement ``_compress(y, rng) -> (deq, mean)`` on an (N, M)
    float32 block of per-client deltas: ``deq`` is each client's
    decompressed message (N, M), ``mean`` its average (M,).
    """

    error_feedback: bool = True

    def init_state(self, stacked):
        return {
            # ref: the shared consensus every client started the round from
            "ref": tree_map(lambda x: x[0].to(torch.float32).clone(),
                            stacked),
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

    def reduce_leaf(self, x, leaf_state, rng):
        """One leaf's EF round: compress (delta + residual), average, carry
        the compression error forward."""
        r, e = leaf_state["ref"], leaf_state["res"]
        n = x.shape[0]
        y = (x.to(torch.float32).reshape(n, -1)
             - r.reshape(1, -1) + e.reshape(n, -1))
        deq, mean_delta = self._compress(y, rng)
        consensus = r.reshape(-1) + mean_delta
        drop = (y - deq) if self.error_feedback else torch.zeros_like(y)
        return (consensus.reshape(r.shape).to(x.dtype),
                {"ref": consensus.reshape(r.shape),
                 "res": drop.reshape(e.shape)})

    def reduce(self, stacked, state, rng):
        leaves, treedef = tree_flatten(stacked)
        states = self.split_state(state, treedef)
        means, new_states = [], []
        for i, (x, st) in enumerate(zip(leaves, states)):
            consensus, ns = self.reduce_leaf(x, st, rng.fold_in(i))
            means.append(consensus)
            new_states.append(ns)
        return treedef.unflatten(means), self.join_state(new_states, treedef)


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

    def _compress(self, y, rng):
        scales = Q.compute_scale(y, dim=1)
        if self.stochastic:
            rbits = rng.bits(y.shape)
        else:
            # 1 << 31 as a uint32 word (u = 0.5), carried as int32
            rbits = torch.full(y.shape, -2 ** 31, dtype=torch.int32,
                               device=y.device)
        q = Q.encode_leaf(y, rbits, scales, bits=self.bits)
        return Q.decode_mean_leaf(q, scales, bits=self.bits)

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

    def _compress(self, y, rng):
        n = y.shape[0]
        k = self._k(y.shape[1])
        idx = torch.topk(torch.abs(y), k, dim=1).indices
        vals = torch.gather(y, 1, idx)
        deq = torch.zeros_like(y).scatter_(1, idx, vals)
        return deq, torch.sum(deq, dim=0) * (1.0 / n)

    def leaf_message_bytes(self, template) -> list:
        # (f32 value + i32 index) per kept entry
        return [8 * self._k(leaf_elems(l)) for l in tree_leaves(template)]


def supports_leaf_bytes(reducer: Reducer) -> bool:
    """True iff ``reducer`` overrides ``leaf_message_bytes`` — the per-leaf
    ledger branches on this probe instead of catching NotImplementedError,
    so a bug inside an implemented per-leaf method propagates."""
    return type(reducer).leaf_message_bytes is not Reducer.leaf_message_bytes


def reduce_streaming(reducer: Reducer, stacked, state, rng):
    """One streaming round: reduce the stacked replica tree leaf by leaf.

    Leaves run in *reverse-layer order* — the order they finish their
    last local step under backprop — and each leaf folds the same per-leaf
    rng the tree-level ``reducer.reduce`` folds (``rng.fold_in(i)``), so
    the result equals the blocking round's exactly. Returns
    ``(consensus tree, new state)`` like ``Reducer.reduce``.
    """
    leaves, treedef = tree_flatten(stacked)
    states = reducer.split_state(state, treedef)
    out = [None] * len(leaves)
    new = [None] * len(leaves)
    for i in reversed(range(len(leaves))):
        out[i], new[i] = reducer.reduce_leaf(leaves[i], states[i],
                                             rng.fold_in(i))
    return treedef.unflatten(out), reducer.join_state(new, treedef)


def get_reducer(spec, *, quant_bits: int = 8,
                topk_frac: float = 0.1) -> Reducer:
    """Resolve a reducer from a config string (or pass a Reducer through).

    Accepted specs: "dense" | "int8" / "quant" (quant_bits-wide) |
    "int<b>" (explicit width) | "topk" (topk_frac). The staleness-weighted
    reducers wait for the event-runtime slice of the port.
    """
    if isinstance(spec, Reducer):
        return spec
    if spec in (None, "dense", "mean"):
        return DenseMean()
    if spec in ("quant", "int8", "quantized"):
        b = 8 if spec == "int8" else quant_bits
        return QuantizedMean(bits=b)
    if spec.startswith("staleness"):
        raise NotImplementedError(
            f"reducer {spec!r}: the staleness-weighted reducer comes with "
            f"the event-runtime slice of the port")
    if spec.startswith("int"):
        return QuantizedMean(bits=int(spec[3:]))
    if spec == "topk":
        return TopKMean(frac=topk_frac)
    raise ValueError(f"unknown reducer spec: {spec!r}")
