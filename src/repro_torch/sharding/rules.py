"""Sharding rules: mesh axis names, activation constraints, param specs.

The port of ``src/repro/sharding/rules.py``. The production mesh axes
(``launch/mesh.py``):

  pod   — inter-pod axis (multi-pod only)
  data  — client / batch axis (the paper's N clients)
  model — tensor-parallel axis (heads / ffn / experts / vocab)

A spec is a ``P``: one entry per tensor dim, each ``None`` (replicated),
an axis name or a tuple of names (the dim split over those mesh axes,
the first the major one). ``to_placements`` turns a spec into DTensor
placements, one per mesh dim, and ``feasible_specs`` replaces an entry
whose dim does not divide by ``None``, as the reference does: DTensor's
uneven sharding is not used, so both packages place the same bytes.

Model code calls ``shard(x, *spec)`` at layer boundaries. It is a no-op
off a mesh (``launch.mesh.mesh_context``) and for a plain tensor, drops
axis names the tensor's mesh lacks, skips the whole constraint when a
dim does not divide, and otherwise redistributes a DTensor to the spec.
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

from repro_torch.utils.tree import tree_flatten_with_path, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"


def _entry(e):
    """One spec entry in its normal form, as jax's PartitionSpec keeps it:
    a tuple of one axis is that axis, an empty tuple None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: one entry per tensor dim. Not a tuple, so that the
    port's tree functions treat it as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``),
    with its DTensor placements."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


# ---------------------------------------------------------------------------
# The active mesh (``mesh_context``)
# ---------------------------------------------------------------------------

_ACTIVE = []


def active_mesh():
    """The innermost mesh of ``mesh_context``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh of ``shard`` for the block (None
    leaves it unchanged): the counterpart of the reference's
    ``launch.mesh.mesh_context``."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's block,
    with no check and no communication."""
    import torch
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def distribute(tree, shardings):
    """A tree of whole tensors, the same on every rank → DTensors placed by
    a tree of ``NamedSharding``: each rank keeps its own block (a copy
    where it is a part of the tensor, the tensor itself where it is all
    of it), no communication; non-tensor leaves (a step count) pass
    through."""
    import torch

    def one(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        return place(x, sh.mesh, sh.placements)

    return tree_map(one, tree, shardings)


def place(x, mesh, placements):
    """A whole tensor, the same on every rank → a DTensor placed by
    ``placements``: this rank keeps its block (a copy where it is a part
    of the tensor), no communication."""
    import torch

    lshape, off = local_shape_and_offset(x.shape, mesh, placements)
    local = x
    for d, (ln, o) in enumerate(zip(lshape, off)):
        if ln != x.shape[d]:
            local = local.narrow(d, o, ln)
    if local is not x:
        # a copy: a slice (even a contiguous one) would keep the whole
        # tensor's storage alive
        local = local.clone(memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements, x.shape)


def submesh(mesh, axes):
    """``mesh[axes]``, made outside any fake mode (the rank grid is
    metadata, not a traced tensor)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return mesh[tuple(axes)]


def local_shape_and_offset(shape, mesh, placements):
    """This rank's block of a tensor of ``shape`` placed by
    ``placements`` on ``mesh``: (local shape, global offset)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    with unset_fake_temporarily():   # metadata: no tensor is traced
        return compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     tuple(placements))


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _filter(entry, names):
    if entry is None:
        return None
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return entry if entry in names else None


def to_placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a mesh
    dim named at tensor dim d is ``Shard(d)`` (a dim over ``("pod",
    "data")`` is ``Shard(0)`` on both, pod-major as the mesh orders
    them), every other mesh dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def shard(x, *spec):
    """The counterpart of ``with_sharding_constraint`` that degrades
    gracefully.

    * a no-op off a mesh and for a plain tensor (the device route, the
      CPU tests, a 1×1 mesh);
    * drops axis names the DTensor's mesh does not carry;
    * SKIPS the whole constraint if a named dim does not divide by its
      mesh axes' size (8 KV heads on a 16-way model axis), as the
      reference does;
    * a mesh dim the spec does not name keeps the tensor's placement on
      it (a pod client's batch stays split over ``data``, as the
      reference's ``spmd_axis_name`` keeps it), unless that placement
      splits a dim the spec names, or is a partial sum: then it becomes
      replicated.
    """
    if active_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    fspec = tuple(_filter(e, set(sizes)) for e in spec)
    for dim, entry in zip(x.shape, fspec):
        total = 1
        for a in _axes(entry):
            total *= sizes[a]
        if dim % total:
            return x
    want = list(to_placements(fspec, mesh))
    named = {a for e in fspec for a in _axes(e)}
    claimed = {d % x.ndim for d, e in enumerate(fspec) if e is not None}
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in named:
            continue
        cur = x.placements[i]
        if isinstance(cur, Shard) and cur.dim % x.ndim not in claimed:
            want[i] = cur
        else:
            want[i] = Replicate()
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Parameter specs.
#
# Leaf-name driven: each rule gives the spec of the *trailing* dims of a
# leaf (the arch dims). Stack dims (layer groups) and the client axis are
# prepended by the caller. ``model``-axis placement follows the Megatron
# layout: column-parallel in-projections, row-parallel out-projections,
# experts split on E, embeddings on vocab.
# ---------------------------------------------------------------------------

_RULES = {
    # embeddings / head
    "embed": ("model", None),          # (vocab, d)
    "unembed": (None, "model"),        # (d, vocab)
    "proj_frontend": (None, None),     # (frontend_dim, d)
    # attention (gqa)
    "wq": (None, "model"),             # (d, H*hd)
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),             # (H*hd, d)
    # attention (mla)
    "w_dq": (None, None),              # (d, q_lora)
    "w_uq": (None, "model"),           # (q_lora, H*(nope+rope))
    "w_dkv": (None, None),             # (d, kv_lora + rope)
    "w_uk": (None, "model"),           # (kv_lora, H*nope)
    "w_uv": (None, "model"),           # (kv_lora, H*v)
    # mlp
    "w_gate": (None, "model"),         # (d, ff)
    "w_up": (None, "model"),
    "w_down": ("model", None),         # (ff, d)
    # moe
    "w_router": (None, None),          # (d, E)
    "we_gate": ("model", None, None),  # (E, d, de)
    "we_up": ("model", None, None),
    "we_down": ("model", None, None),  # (E, de, d)
    # mamba2 / ssd
    "w_in": (None, "model"),           # (d, d_in_proj)
    "w_out_ssm": ("model", None),      # (d_inner, d)
    "conv_w": (None, "model"),         # (d_conv, conv_channels)
    "A_log": ("model",),               # (n_heads,)
    "D": ("model",),
    "dt_bias": ("model",),
    "ssm_norm": ("model",),            # (d_inner,) gated rmsnorm
    # rg-lru
    "w_x": (None, "model"),            # (d, lru)
    "w_gate_lru": (None, "model"),
    "conv_lru": (None, "model"),       # (d_conv, lru)
    "a_param": ("model",),             # (lru,)
    "w_in_gate": ("model", None),
    "w_out_lru": ("model", None),      # (lru, d)
    "gate_w": ("model", None, None),
}

_REPLICATED_SUFFIXES = ("norm", "scale", "bias", "q_norm", "k_norm", "kv_norm")

_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def leaf_name(path: str) -> str:
    """A leaf's name: the last dict key of its keystr path."""
    keys = _KEY.findall(path)
    return keys[-1] if keys else "unnamed"


def spec_for_leaf(name: str, ndim: int, extra_leading: int = 0):
    """P for a named leaf with ``extra_leading`` stack/client dims."""
    base = _RULES.get(name, (None,) * (ndim - extra_leading))
    spec = (None,) * extra_leading + tuple(base)
    assert len(spec) == ndim, f"{name}: spec {spec} vs ndim {ndim}"
    return P(*spec)


def _base_ndim(name: str, ndim: int, client_axis) -> int:
    if name in _RULES:
        return len(_RULES[name])
    # replicated leaves: every leading dim is a stack/client dim except
    # the last (the feature dim); scalars pass through
    return min(ndim, 1)


def _named_map(fn, tree):
    """tree_map of fn(name, leaf), the name a leaf's last dict key."""
    flat, treedef = tree_flatten_with_path(tree)
    return treedef.unflatten([fn(leaf_name(p), l) for p, l in flat])


def param_specs(params, client_axis=None, fsdp_axis: Optional[str] = None):
    """Tree of P matching ``params``.

    Leaves are named by their dict key; stacked-layer dims and the
    optional client axis are leading. ``client_axis`` ('data', 'pod' or a
    tuple of them) goes on dim 0 when given (training replicas); other
    leading dims (layer stacks) are unsharded. ``fsdp_axis`` (pod-client
    mode: 'data') goes on the first unsharded weight dim — ZeRO-3-style
    intra-pod parameter sharding.
    """
    if isinstance(client_axis, list):
        client_axis = tuple(client_axis)

    def one(name, leaf):
        base_ndim = _base_ndim(name, leaf.ndim, client_axis)
        extra = leaf.ndim - base_ndim
        entries = list(spec_for_leaf(name, leaf.ndim, extra_leading=extra))
        # exclusions: embed/unembed — FSDP on the table's d_model dim turns
        # every token lookup into a full re-gather; expert weights — they
        # are already E-split on `model`
        if (fsdp_axis is not None and name in _RULES and base_ndim >= 2
                and name not in ("embed", "unembed",
                                 "we_gate", "we_up", "we_down")):
            for i in range(leaf.ndim - base_ndim, leaf.ndim):
                if entries[i] is None:
                    entries[i] = fsdp_axis
                    break
        if client_axis is not None:
            entries[0] = client_axis
        return P(*entries)

    return _named_map(one, params)


def feasible_specs(specs, shapes, mesh):
    """Drop spec entries whose dim does not divide by the mesh axes'
    product (vocab 92553 on a 16-way model axis): those leaves are
    replicated on that dim, in both packages."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        shape = leaf.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, e in zip(shape, entries):
            tot = 1
            for a in _axes(e):
                tot *= sizes.get(a, 1)
            out.append(e if e is None or dim % tot == 0 else None)
        return P(*out)

    return tree_map(fix, specs, shapes)


# ---------------------------------------------------------------------------
# KV / recurrent cache specs (serving)
# ---------------------------------------------------------------------------

def cache_specs(cache, data_axes=("data",), seq_axes=()):
    """Tree of P for a decode cache (leading stack dims allowed).

    ``data_axes`` split the batch dim; ``seq_axes`` (used when the batch
    is too small, as long_500k's b=1) split the sequence dim of the
    k/v/ckv/k_rope buffers.
    """
    data_axes = tuple(data_axes)
    seq_axes = tuple(seq_axes)
    bspec = data_axes if data_axes else None
    sspec = seq_axes if seq_axes else None

    def one(name, leaf):
        if name == "pos":
            return P()
        if name == "state":
            # mamba2 (B,H,P,N) vs rglru (B,lru): by trailing ndim
            base = ((bspec, "model", None, None) if leaf.ndim >= 4
                    else (bspec, "model"))
        elif name in ("k", "v"):
            base = (bspec, sspec, "model", None)
        elif name in ("k_scale", "v_scale"):
            base = (bspec, sspec, "model")
        elif name in ("ckv", "k_rope"):
            base = (bspec, sspec, None)
        elif name == "conv":
            base = (bspec, None, "model")
        else:
            base = (None,) * leaf.ndim
        return P(*(((None,) * (leaf.ndim - len(base))) + tuple(base)))

    return _named_map(one, cache)


# ---------------------------------------------------------------------------
# Kernels on local shards
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def unshard_dim(x, dim: int):
    """A DTensor with no mesh dim splitting tensor dim ``dim`` (those
    become replicated): before a reshape that cuts the dim into pieces
    the split does not divide (8 KV heads on 16 ranks)."""
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim
            else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def model_size(x) -> int:
    """The size of the ``model`` axis of a DTensor's mesh (1 without)."""
    return axis_sizes(x.device_mesh).get(MODEL_AXIS, 1)


def head_placements(x, head_dim: int, split: bool, model=None,
                    batch: bool = True):
    """Placements for a kernel's input ``x`` (a DTensor): on ``model``,
    ``Shard(head_dim)`` if ``split`` else ``model`` (default
    ``Replicate()``); on any other mesh dim the batch split (dim 0) of a
    pod client's ``data`` shards is kept where ``batch``, anything else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, cur in zip(x.device_mesh.mesh_dim_names, x.placements):
        if name == MODEL_AXIS:
            out.append(Shard(head_dim) if split else (model or Replicate()))
        else:
            out.append(Shard(0) if batch and isinstance(cur, Shard)
                       and cur.dim == 0 else Replicate())
    return tuple(out)


def contiguous_grad(t):
    """``t``, whose gradient is made contiguous on the way back: a
    kernel's Function on local shards (``local_map``) may return a
    gradient in any layout, and DTensor takes a local block to be
    contiguous when it views it."""
    import torch

    class _ContiguousGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return t if t is None else _ContiguousGrad.apply(t)
