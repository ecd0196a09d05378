"""Where a stacked leaf's block lies on a device mesh, and the collectives
a communication round runs over it.

On a mesh (``core/local_sgd.py``'s mesh route) every stacked (C, ...)
leaf is a DTensor: its client dim split over the client axes (``data``,
``("pod", "data")`` or ``pod``), its other dims as the sharding rules say
(``model``, and ``data`` for a pod client's FSDP split). A rank holds a
(C_local, ...) block of C_local whole clients' shards. The reducers
(``comm/reducer.py``) and the two-level topology (``engine/topology.py``)
take a ``LeafShards`` per leaf and run their round on the rank's block:

  * ``ClientGroup.mean`` — the dense mean over all C clients: the block's
    float32 sum all-reduced over the client axes and rounded once (a
    one-rank group takes the device route's ``torch.mean``, bit for bit);
  * ``ClientGroup.gather`` — an int8 round's codes and scales
    all-gathered over the client axes, in client order (the bytes the
    ledger prices);
  * ``replica_max`` — a per-client scale is a max over the whole leaf:
    all-reduced (MAX) over the mesh dims that split the leaf's other dims;
  * ``local_bits`` — a key's bits are drawn for the whole (C, M) leaf,
    as on one device, and the rank keeps its own elements in the leaf's
    shape, so its codes equal the single-device codes exactly;
  * ``gather_split`` / ``flat_index`` — a top-k round's candidates
    (magnitudes and their flat indices in the leaf) all-gathered over the
    mesh dims that split the leaf, and ``ClientGroup.sum`` its float32
    sum of the messages over the client axes.

Every collective is a functional collective (``_c10d_functional``), so
the dry run's dispatch mode (``launch/collectives.py``) sees it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_FLAT: Dict[Tuple[int, Tuple[str, ...]], object] = {}


def axes_group(mesh, axes: Tuple[str, ...]):
    """The group of ``mesh``'s ranks that differ only along ``axes``, in
    the form the functional collectives take: (mesh, dim) for one axis, a
    flattened 1-D mesh for several (made once per mesh and axes, on every
    rank in the same order)."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    if len(axes) == 1:
        return (mesh, names.index(axes[0]))
    key = (id(mesh), axes)
    if key not in _FLAT:
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():   # the rank grid is metadata
            _FLAT[key] = mesh[axes]._flatten("_".join(axes))
    return _FLAT[key]


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class ClientGroup:
    """The client axes of a mesh: C clients split into contiguous blocks,
    one a rank coordinate along the axes (pod-major)."""

    def __init__(self, mesh, axes, n_clients: int):
        self.mesh = mesh
        self.axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
        sizes = _sizes(mesh)
        self.size = math.prod(sizes[a] for a in self.axes)
        if n_clients % self.size:
            raise ValueError(f"{n_clients} clients do not split over "
                             f"{dict((a, sizes[a]) for a in self.axes)}")
        self.n_clients = n_clients
        self.n_local = n_clients // self.size
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        idx = 0
        for a in self.axes:
            idx = idx * sizes[a] + coord[a]
        self.index = idx
        self.group = axes_group(mesh, self.axes) if self.size > 1 else None

    def mean(self, x):
        """The mean over all clients of a (C_local, ...) block, as
        ``torch.mean`` and the reference's ``jnp.mean`` make it: the
        block's float32 sum all-reduced in float32 over the group,
        divided by C and rounded once to x's type."""
        if self.group is None:
            return torch.mean(x, dim=0)
        return (self.sum(x) / self.n_clients).to(x.dtype)

    def sum(self, x):
        """The float32 sum over all clients of a (C_local, ...) block: the
        block's sum all-reduced over the group (a top-k round's
        ``sum(deq) * (1/n)``)."""
        part = torch.sum(x.to(torch.float32), dim=0)
        if self.group is None:
            return part
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(part, "sum", self.group))

    def sum_scalar(self, t):
        """A scalar's sum over the group (the loss metric)."""
        if self.group is None:
            return t
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", self.group))

    def gather(self, x):
        """(C_local, ...) blocks → (C, ...) in client order."""
        if self.group is None:
            return x
        return _all_gather(x, self.group)


def _all_gather(x, group):
    """The group's blocks of ``x`` stacked on dim 0, in group order."""
    from torch.distributed import _functional_collectives as funcol

    gather = (getattr(funcol, "all_gather_single", None)
              or funcol.all_gather_tensor)   # the name before 2.12
    return funcol.wait_tensor(gather(x.contiguous(), 0, group))


class LeafShards:
    """One stacked leaf on a mesh: its global (C, ...) shape, its
    placements on the whole mesh and the client group of its dim 0."""

    def __init__(self, clients: ClientGroup, shape, placements):
        from torch.distributed.tensor import Shard

        self.clients = clients
        self.shape = tuple(shape)
        self.placements = tuple(placements)
        sizes = _sizes(clients.mesh)
        # the mesh dims of more than one rank that split a dim past the
        # client dim
        self.split_axes = tuple(
            n for n, p in zip(clients.mesh.mesh_dim_names, self.placements)
            if isinstance(p, Shard) and p.dim % len(self.shape) != 0
            and sizes[n] > 1)

    def replica_max(self, t):
        """Max over the ranks that hold other parts of the same clients'
        leaf (per client row of ``t``)."""
        if not self.split_axes:
            return t
        from torch.distributed import _functional_collectives as funcol

        group = axes_group(self.clients.mesh, self.split_axes)
        return funcol.wait_tensor(funcol.all_reduce(t, "max", group))

    def gather_split(self, x):
        """(C_local, K) rows of this rank → (C_local, R·K): the same
        clients' rows of every rank that holds another part of their leaf
        (R ranks over ``split_axes``), side by side."""
        group = axes_group(self.clients.mesh, self.split_axes)
        parts = _all_gather(x, group)
        return (parts.reshape((-1,) + tuple(x.shape)).transpose(0, 1)
                .reshape(x.shape[0], -1))

    def _block(self):
        """This rank's block of the leaf: (local shape, global offset)."""
        from repro_torch.sharding.rules import local_shape_and_offset

        return local_shape_and_offset(self.shape, self.clients.mesh,
                                      self.placements)

    def flat_index(self, pos):
        """Positions in this rank's block of one client's row (int64,
        row-major over the block) → their flat indices in the whole row of
        the leaf. The block is a box of the leaf, so the map keeps order."""
        lshape, off = self._block()
        out = torch.zeros_like(pos)
        rest, stride = pos, 1
        for d in reversed(range(1, len(self.shape))):
            out += (rest % lshape[d] + off[d]) * stride
            rest = rest // lshape[d]
            stride *= self.shape[d]
        return out

    def local_bits(self, rng):
        """The key's bits for the whole (C, M) leaf, this rank's elements,
        as (C_local, M_local) int32."""
        n = self.shape[0]
        bits = rng.bits((n, math.prod(self.shape[1:]))).reshape(self.shape)
        lshape, off = self._block()
        for d, (ln, o) in enumerate(zip(lshape, off)):
            if ln != self.shape[d]:
                bits = bits.narrow(d, o, ln)
        return bits.reshape(lshape[0], -1).contiguous()


_GROUPS: Dict[tuple, ClientGroup] = {}


def client_group(mesh, axes, n_clients: int) -> ClientGroup:
    """``ClientGroup(mesh, axes, n_clients)``, made once per arguments."""
    key = (id(mesh), tuple(axes), n_clients)
    if key not in _GROUPS:
        _GROUPS[key] = ClientGroup(mesh, axes, n_clients)
    return _GROUPS[key]


def over(sh: LeafShards, axes, n_clients: int) -> LeafShards:
    """The same leaf seen as ``n_clients`` stacked rows split over
    ``axes`` alone (a two-level round's hop: a pod's clients over
    ``data``, the pod means over ``pod``); the other client axes hold
    copies."""
    from torch.distributed.tensor import Replicate

    mesh = sh.clients.mesh
    group = client_group(mesh, axes, n_clients)
    pl = tuple(Replicate() if n in sh.clients.axes and n not in group.axes
               else p for n, p in zip(mesh.mesh_dim_names, sh.placements))
    return LeafShards(group, (n_clients,) + sh.shape[1:], pl)


def row_placements(placements, ndim: int):
    """A stacked leaf's placements for one row of it (the consensus, the
    reference point ``ref``): the client split dropped, other dims moved
    down one."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in placements:
        if isinstance(p, Shard):
            d = p.dim % ndim
            out.append(Replicate() if d == 0 else Shard(d - 1))
        else:
            out.append(p)
    return tuple(out)
