"""What a traced step communicates, computes and holds, per rank.

The counterpart of ``src/repro/launch/hlo_analysis.py``. The reference
parses the partitioned HLO text of a compiled program; the port has no
HLO. The dry run (``launch/dryrun.py``) runs a step once, eagerly, on a
``fake`` process group under ``FakeTensorMode`` (``torch.distributed``'s
functional collectives record nothing and move nothing there), and a
dispatch mode (``TraceRecorder``) sees every op the rank issues:

  * every collective (the ``_c10d_functional`` / ``c10d_functional``
    ops: all-reduce, all-gather, reduce-scatter, all-to-all, broadcast;
    and ``_dtensor.shard_dim_alltoall``, the all-to-all that DTensor
    issues to move a shard from one tensor dim to another) with its kind, its bytes (the output's, as the reference takes the
    HLO op's output type) and the mesh axes its group spans (the axes
    whose coordinates vary over the group's ranks, as the reference's
    ``_axes_of_group`` reads a replica group);
  * the bytes every other non-view op reads and writes (``cost_summary``:
    what an unfused step moves; ``prim`` ops, which read metadata such
    as a tensor's device, move none), and the calls of each kernel's op
    (``kernels/trace.py``: the ``repro_torch`` namespace);
  * the bytes of the fake tensors alive at once: each new storage an op
    returns counts from its first tensor's birth to that tensor's death
    (a view keeps its base alive), the arguments' storages throughout
    (``memory_summary``; the same mode that sees the collectives, so the
    count does not depend on another tracker's rules).

``link_bytes`` uses the reference's ring factors (``hlo_analysis.py``:
all-reduce 2·(n−1)/n of its bytes over the busiest link, all-gather,
reduce-scatter and all-to-all (n−1)/n, a permute or broadcast 1×).
Eager tracing sees each collective as many times as it runs — a layer
loop, a microbatch loop, a client loop are Python loops here — so the
reference's while-loop trip-count weighting (``parse_collectives_nested``)
has no counterpart. FLOPs come from ``torch.utils.flop_counter``, the
kernels' ops counted by the formulas ``kernels/trace.py`` registers.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def link_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes over the busiest link of a ring collective of ``n`` ranks
    whose output is ``nbytes`` (the reference's factors)."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / max(n, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (n - 1) / max(n, 1)
    return float(nbytes)


def _storage_bytes(t) -> int:
    return t.untyped_storage().nbytes()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def axes_of_ranks(ranks, mesh) -> tuple:
    """The mesh axes whose coordinates vary over ``ranks``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():   # the rank grid is metadata
        grid = mesh.mesh
        coords = []
        for r in ranks:
            hit = (grid == r).nonzero()
            if hit.numel():
                coords.append(tuple(hit[0].tolist()))
    if not coords:
        return ("unknown",)
    return tuple(n for i, n in enumerate(mesh.mesh_dim_names)
                 if len({c[i] for c in coords}) > 1)


class TraceRecorder(TorchDispatchMode):
    """Records the collectives and the unfused bytes of what runs under
    it (enter it inside ``FakeTensorMode``)."""

    def __init__(self, mesh, arguments=()):
        super().__init__()
        self.mesh = mesh
        self.collectives: List[dict] = []
        self.bytes_accessed = 0
        self.kernels: Dict[str, int] = defaultdict(int)
        self._axes: Dict[str, tuple] = {}
        # storage → bytes of what is alive; the arguments' stay counted
        self._live = {t.untyped_storage()._cdata: _storage_bytes(t)
                      for t in arguments}
        self.argument_bytes = sum(self._live.values())
        self.live_bytes = self.peak_bytes = self.argument_bytes

    def _alive(self, out):
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self._live:
                continue
            n = _storage_bytes(t)
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._dead, key)

    def _dead(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _group(self, name: str):
        if name not in self._axes:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group

            pg = _resolve_process_group(name)
            ranks = dist.get_process_group_ranks(pg)
            self._axes[name] = (axes_of_ranks(ranks, self.mesh), len(ranks))
        return self._axes[name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _NAMESPACES and name in _KINDS:
            group = kwargs.get("group_name", args[-1])
            axes, n = self._group(group)
            kind = _KINDS[name]
            nbytes = _nbytes(out)
            self.collectives.append({
                "kind": kind, "bytes": nbytes,
                "link_bytes": link_bytes(kind, nbytes, n),
                "group_size": n, "axes": list(axes)})
        elif ns not in _NAMESPACES + ("prim",) and not func.is_view:
            self.bytes_accessed += (_nbytes(list(args)) + _nbytes(out))
            if ns == "repro_torch":
                self.kernels[name] += 1
        if not func.is_view:
            self._alive(out)
        return out


def collective_summary(colls: List[dict]) -> dict:
    """Link bytes in all, by mesh axes (joined by '+') and by kind: the
    reference's keys."""
    by_axes = defaultdict(float)
    by_kind = defaultdict(float)
    for c in colls:
        by_axes["+".join(c["axes"]) or "none"] += c["link_bytes"]
        by_kind[c["kind"]] += c["link_bytes"]
    return {"total_link_bytes": sum(c["link_bytes"] for c in colls),
            "count": len(colls),
            "by_axes": dict(by_axes), "by_kind": dict(by_kind)}


def memory_summary(argument_bytes: int, output_bytes: int,
                   peak_bytes: int) -> dict:
    """Per-rank bytes: the arguments (the state's and batch's local
    blocks), the outputs the step allocated, the rest of the peak
    (temporaries) and the peak of the fake tensors alive at once
    (arguments included). An in-place step's outputs are its arguments,
    so its output bytes are what it returns beside them."""
    return {"argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(max(peak_bytes - argument_bytes
                                  - output_bytes, 0)),
            "alias_bytes": 0,
            "peak_bytes": int(peak_bytes)}


def cost_summary(flops: float, bytes_accessed: float) -> dict:
    return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
            "transcendentals": None}
