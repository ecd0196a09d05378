"""Local-SGD step builders for transformer training: the clients on one
device, or split over a device mesh.

The port of ``src/repro/core/local_sgd.py``. The training state is
``{"params": (C, ...), "opt": (C, ...), "step": int}``: every leaf carries
a leading client axis, and the parameters keep the reference's grouped
layout (``models/transformer.py::to_grouped``), so a communication round
reduces the reference's leaves.

  * ``train_step_local`` — every client takes one SGD step on its own
    replica. The reference vmaps the step over the client axis; here the
    clients run as a loop (the flash-attention autograd Function has no
    vmap rule, and at full width each client's step is GEMM-bound, so C
    launches of each op cost nothing). Client c trains on
    ``p[c].detach().requires_grad_()`` — views of the stacked leaves, no
    copy — and its update is one fused-update launch on its rows: C
    launches per local step. Executed k_s times per round.
  * ``sync_step`` — Algorithm 1 line 5, the parameter-averaging round,
    through the ported reducers and topologies; the consensus is copied
    back into every replica and the optimizer moments are dense-averaged.
  * the two-level round (``inter_reducer`` with a client axis spanning
    ``"pod"``): ``engine.Hierarchical.reduce``, a dense (or compressed)
    intra-pod hop and a compressed inter-pod hop, as the simulator runs it.
  * pod-client mode (``client_axis="pod"``): each client's batch is split
    over its ``data`` shards and the shards' gradients are averaged inside
    the step (SyncSGD within a pod).

Unlike the reference's pure functions, both steps update the state's
tensors in place and return the state.

A client's step runs in three profiler ranges (``obs/trace.layer``):
``local_sgd.forward`` (the loss), ``local_sgd.backward``
(``torch.autograd.grad``, the remat recompute inside it) and
``local_sgd.update`` (the optimizer's update).

On a device mesh (``build_train_steps(cfg, mesh)``, a ``DeviceMesh`` from
``launch/mesh.py``) the state's leaves are DTensors placed by
``state_shardings`` (``place_state``): the client dim split over the
client axes, the other dims by the sharding rules. The local step loops
over this rank's clients and issues no collective on the client axes
(the reference's "local step: NO client-axis comm"), apart from the
loss metric's one scalar. Where the replica axes (the mesh dims that are
not client axes) have one rank, a client's forward and backward run on
plain local tensors, the device route's code (so a 1×1 mesh is bit-equal
to it); otherwise on DTensors over the replica axes, DTensor's
propagation and the ``shard`` constraints standing in for GSPMD and the
kernels running on local shards (``local_map``). The update is one
fused-update launch per client on its local shards. The sync round
reduces the rank's blocks over the client axes (``comm/shards.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.comm import get_reducer
from repro_torch.comm.reducer import DenseMean, reduce_streaming
from repro_torch.comm.shards import (LeafShards, client_group, over,
                                     row_placements)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulate import _copy_broadcast_, resolve_device
from repro_torch.engine.topology import Hierarchical
from repro_torch.models import transformer as TF
from repro_torch.obs.trace import layer
from repro_torch.optim import make_optimizer
from repro_torch.sharding.rules import (NamedSharding, P, axis_sizes,
                                        distribute, feasible_specs,
                                        from_local, is_dtensor, mesh_context,
                                        param_specs, place, submesh)
from repro_torch.utils.rng import TorchKey
from repro_torch.utils.tree import (tree_broadcast_leading, tree_flatten,
                                    tree_leaves, tree_map, tree_mean_leading)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ArchConfig, batch):
    """Next-token CE. params: the grouped layout; batch: {"tokens",
    "labels": (B, S) integer tensors} [+ "frontend": (B, n_fe,
    frontend_dim)]."""
    logits, aux = TF.forward(TF.layer_views(params, cfg), cfg,
                             batch["tokens"], batch.get("frontend"))
    S = batch["labels"].shape[1]
    logits = logits[:, -S:, :]   # drop the frontend positions
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    return torch.mean(nll) + aux


# ---------------------------------------------------------------------------
# Sync round
# ---------------------------------------------------------------------------

def _round_key(rng, base_seed: int, params, step: int):
    """fold_in(key(base_seed), step): the reducer's key of this round."""
    root = (rng if rng is not None
            else TorchKey(base_seed, tree_leaves(params)[0].device))
    return root.fold_in(int(step))


def _finish_round(state, consensus, **extra):
    """Copy the consensus into every replica and dense-average the
    optimizer moments (they never cross the network; the average mirrors
    Alg. 1's replica consensus), in place."""
    _copy_broadcast_(state["params"], consensus)
    _copy_broadcast_(state["opt"], tree_mean_leading(state["opt"]))
    return dict(state, **extra)


# ---------------------------------------------------------------------------
# The mesh: local blocks, placements, the client group
# ---------------------------------------------------------------------------

def is_mesh(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(x, DeviceMesh)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks (a fake mesh's fake CUDA tensors,
    in a process with no card, sit on cuda:0)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return torch.device(mesh.device_type)


def _axes_tuple(client_axis) -> tuple:
    return (tuple(client_axis) if isinstance(client_axis, (tuple, list))
            else (client_axis,))


def _local(x):
    """A leaf's block on this rank: a DTensor's local tensor; a plain
    tensor is its own (a mesh whose ranks hold whole leaves)."""
    return x.to_local() if is_dtensor(x) else x


def _leaf_placements(x, mesh):
    if is_dtensor(x):
        return tuple(x.placements)
    if mesh.size() != 1:
        raise ValueError("a plain tensor in a state on a mesh of "
                         f"{mesh.size()} ranks: place the state first "
                         "(place_state)")
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def _mesh_shards(tree, mesh, client_axes):
    """(local blocks tree, one LeafShards a leaf) of a stacked tree."""
    leaves, treedef = tree_flatten(tree)
    group = client_group(mesh, client_axes, leaves[0].shape[0])
    shards = [LeafShards(group, x.shape, _leaf_placements(x, mesh))
              for x in leaves]
    return treedef.unflatten([_local(x) for x in leaves]), shards


def _ref_layouts(shards, refs=None):
    """(placements, global shape) of a compressed reducer's ``ref``, a leaf
    at a time: a row of its leaf; with ``refs`` (one ``LeafShards`` a
    leaf, the leaf seen over ``pod``), a two-level round's intra state,
    the (n_pods, ...) stack of the pods' refs placed as ``refs`` say."""
    if refs is None:
        return [(row_placements(sh.placements, len(sh.shape)), sh.shape[1:])
                for sh in shards]
    return [(sh.placements, sh.shape) for sh in refs]


def _wrap_delta_state(st, shards, mesh, refs=None):
    """A compressed reducer's state on this rank's blocks → DTensors:
    ``ref`` as ``_ref_layouts`` says (with ``refs``, this rank's block is
    its pod's row of the stack), ``res`` as the leaf."""
    if st is None:
        return None
    ref, treedef = tree_flatten(st["ref"])
    res = treedef.flatten_up_to(st["res"])
    ref = [from_local(r if refs is None else r[None], mesh, pl, shape)
           for r, (pl, shape) in zip(ref, _ref_layouts(shards, refs))]
    return {"ref": treedef.unflatten(ref),
            "res": treedef.unflatten([
                from_local(e, mesh, sh.placements, sh.shape)
                for e, sh in zip(res, shards)])}


def _local_comm(comm):
    return tree_map(_local, comm) if comm is not None else None


def _local_intra(intra):
    """A two-level round's intra state on the mesh → this rank's pod's
    state on its blocks (a dense hop's ``(None,) * n_pods`` as it is)."""
    if not isinstance(intra, dict):
        return intra
    return {"ref": tree_map(lambda r: _local(r)[0], intra["ref"]),
            "res": tree_map(_local, intra["res"])}


# ---------------------------------------------------------------------------
# Sync round
# ---------------------------------------------------------------------------

def _build_mesh_sync_step(reducer, mesh, client_axis, base_seed: int,
                          streaming: bool, rng, topo=None):
    """The sync round on a mesh: the reducer (or the two-level ``topo``)
    on this rank's blocks, its state kept as DTensors."""
    caxes = _axes_tuple(client_axis)
    dense = isinstance(reducer, DenseMean)

    def sync_step(state):
        params, shards = _mesh_shards(state["params"], mesh, caxes)
        opt, _ = _mesh_shards(state["opt"], mesh, caxes)
        key = _round_key(rng, base_seed, params, state["step"])
        if (topo.all_dense if topo is not None else dense):
            if streaming:
                consensus, _ = reduce_streaming(reducer, params, None, key,
                                                shards)
            else:
                consensus, _ = reducer.reduce(params, None, key, shards)
            extra = {}
        elif topo is not None:
            n = shards[0].shape[0]
            if n % topo.n_pods:
                raise ValueError(f"{n} client replicas not divisible into "
                                 f"{topo.n_pods} pods")
            comm = state.get("comm")
            comm = (topo.init_state(params, shards) if comm is None
                    else {"intra": _local_intra(comm["intra"]),
                          "inter": _local_comm(comm["inter"])})
            consensus, comm = topo.reduce(params, comm, key, shards)
            pods = [over(sh, ("pod",), topo.n_pods) for sh in shards]
            intra = comm["intra"]
            if isinstance(intra, dict):
                # the pods' refs stacked and split over `pod`, the
                # residuals placed as the params
                intra = _wrap_delta_state(intra, shards, mesh, refs=pods)
            extra = {"comm": {"intra": intra,
                              "inter": _wrap_delta_state(comm["inter"],
                                                         pods, mesh)}}
        else:
            comm = state.get("comm")
            comm = (reducer.init_state(params, shards) if comm is None
                    else _local_comm(comm))
            if streaming:
                consensus, comm = reduce_streaming(reducer, params, comm,
                                                   key, shards)
            else:
                consensus, comm = reducer.reduce(params, comm, key, shards)
            extra = {"comm": _wrap_delta_state(comm, shards, mesh)}
        _copy_broadcast_(params, consensus)
        group = shards[0].clients
        _copy_broadcast_(opt, tree_map(group.mean, opt))
        return dict(state, **extra)

    return sync_step


def build_sync_step(reducer=None, *, base_seed: int = 0,
                    streaming: bool = False, hierarchical: bool = False,
                    n_pods: int = 2, inter_reducer="int8", rng=None,
                    mesh=None, client_axis="data"):
    """Reducer-aware Algorithm 1 line 5: the parameter-averaging round.

    Returns ``sync_step(state) -> state``, in place. With the default
    DenseMean this is the plain average (no ``comm`` key is added). With
    a compressed reducer each client's message is compressed with error
    feedback; the residual state rides in ``state["comm"]`` (created on
    the first sync), and the round's key is ``fold_in(key(base_seed),
    state["step"])`` — ``rng`` replaces ``key(base_seed)``
    (``utils/rng.py``; default ``TorchKey(base_seed)`` on the params'
    device).

    ``streaming=True`` reduces leaf by leaf in reverse-layer order
    (``engine.StreamingStar`` semantics), equal to the blocking round.
    ``hierarchical=True`` runs the two-level round over ``n_pods``
    contiguous pods of clients (``engine.Hierarchical``): ``reducer``
    intra-pod, ``inter_reducer`` over the pod means; ``n_pods=1`` and
    dense∘dense give the flat round exactly.

    ``mesh``: a DeviceMesh holding the state split over ``client_axis``
    (the two-level round: ``("pod", "data")``, its pods the mesh's
    ``pod`` axis); the round then runs on each rank's blocks — dense: an
    all-reduce over the client axes; int8: the codes and scales
    all-gathered over them, each rank's columns averaged by
    ``dequant_mean``; two-level: the intra hop over ``data``, the inter
    hop over ``pod``.
    """
    reducer = get_reducer(reducer)
    dense = isinstance(reducer, DenseMean)

    if hierarchical:
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        if n_pods > 1:
            return _build_two_level_sync_step(reducer, n_pods, inter_reducer,
                                              base_seed, streaming, rng,
                                              mesh, client_axis)
        # one pod has no inter-pod hop: the flat round with the intra
        # reducer

    if mesh is not None:
        sync_step = _build_mesh_sync_step(reducer, mesh, client_axis,
                                          base_seed, streaming, rng)
    else:
        def sync_step(state):
            params = state["params"]
            key = _round_key(rng, base_seed, params, state["step"])
            if dense and not streaming:
                return _finish_round(state, tree_mean_leading(params))
            if dense:
                consensus, _ = reduce_streaming(reducer, params, None, key)
                return _finish_round(state, consensus)
            comm = state.get("comm")
            if comm is None:
                comm = reducer.init_state(params)
            if streaming:
                consensus, comm = reduce_streaming(reducer, params, comm,
                                                   key)
            else:
                consensus, comm = reducer.reduce(params, comm, key)
            return _finish_round(state, consensus, comm=comm)

    # the tags StagewiseDriver prices the round by
    sync_step.reducer = reducer
    sync_step.streaming = streaming
    sync_step.hierarchical = False
    return sync_step


def _build_two_level_sync_step(intra, n_pods: int, inter_reducer,
                               base_seed: int, streaming: bool, rng,
                               mesh=None, client_axis=("pod", "data")):
    """The hierarchical (n_pods > 1) round behind ``build_sync_step``: one
    ``Hierarchical.reduce`` a sync, the per-hop reducer state in
    ``state["comm"]`` (none for dense∘dense, as the flat dense round)."""
    topo = Hierarchical(n_pods=n_pods, intra=intra,
                        inter=get_reducer(inter_reducer), streaming=streaming)

    if mesh is not None:
        sizes = axis_sizes(mesh)
        if sizes.get("pod") != n_pods:
            raise ValueError(f"the two-level round over {n_pods} pods on a "
                             f"mesh with axes {sizes}: its pod axis must "
                             f"have {n_pods} ranks")
        sync_step = _build_mesh_sync_step(intra, mesh, client_axis,
                                          base_seed, streaming, rng, topo)
    else:
        def sync_step(state):
            params = state["params"]
            n = tree_leaves(params)[0].shape[0]
            if n % n_pods:
                raise ValueError(
                    f"{n} client replicas not divisible into {n_pods} pods")
            key = _round_key(rng, base_seed, params, state["step"])
            if topo.all_dense:
                consensus, _ = topo.reduce(params, None, key)
                return _finish_round(state, consensus)
            comm = state.get("comm")
            if comm is None:
                comm = topo.init_state(params)
            consensus, comm = topo.reduce(params, comm, key)
            return _finish_round(state, consensus, comm=comm)

    sync_step.reducer = intra
    sync_step.streaming = streaming
    sync_step.hierarchical = True
    sync_step.n_pods = n_pods
    sync_step.inter_reducer = topo.inter
    return sync_step




def sync_step_tags(sync_step) -> dict:
    """The comm tags ``build_sync_step`` stamped on a round, read through
    any stack of wrappers that chain ``__wrapped__`` (``functools.wraps``
    decorators).

    Returns ``{"reducer", "streaming", "hierarchical"}`` plus
    ``{"n_pods", "inter_reducer"}`` for two-level rounds; absent tags come
    back ``None``/``False``. ``StagewiseDriver`` reads its comm accounting
    and its trace-span attributes from here.
    """
    def tag(name, default=None):
        fn, v = sync_step, None
        for _ in range(8):   # walk the full wrapper chain (cycle-safe)
            if fn is None:
                break
            v = getattr(fn, name, None)
            if v is not None:
                break
            fn = getattr(fn, "__wrapped__", None)
        return default if v is None else v

    tags = {"reducer": tag("reducer"),
            "streaming": bool(tag("streaming", False)),
            "hierarchical": bool(tag("hierarchical", False))}
    if tags["hierarchical"]:
        tags["n_pods"] = tag("n_pods")
        tags["inter_reducer"] = tag("inter_reducer")
    return tags



# ---------------------------------------------------------------------------
# Local steps
# ---------------------------------------------------------------------------

def _rows(tree, c: int):
    """Client c's replica: a view of row c of every stacked leaf."""
    return tree_map(lambda x: x[c], tree)


def _mean_trees(trees):
    return tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *trees)


def build_train_steps(cfg: ArchConfig, mesh_or_device=None, *,
                      client_axis="data", optimizer: str = "sgd",
                      momentum: float = 0.0, weight_decay: float = 0.0,
                      loss_fn: Optional[Callable] = None,
                      microbatch: int = 1, sync_grads: bool = False,
                      reducer=None, streaming: bool = False,
                      inter_reducer=None, n_pods: int = 2, rng=None):
    """Returns (train_step_local, sync_step, per_client_step).

    train_step_local(state, batch, eta) -> (state, {"loss"}), in place;
        batch leaves (C, B, S) on the state's device ((C, data_shards,
        per_shard, S) in pod-client mode), a frontend arch's
        ``"frontend"`` leaf (C, B, n_fe, frontend_dim).
    sync_step(state) -> state: ``build_sync_step(reducer,
        streaming=streaming, rng=rng)``, or with ``inter_reducer`` (and a
        ``client_axis`` holding ``"pod"``, e.g. ``("pod", "data")``) the
        two-level round over ``n_pods`` pods.
    per_client_step(params, opt_state, batch, eta) -> (params, opt_state,
        loss): one client's step on its own trees, in place.

    ``mesh_or_device``: a DeviceMesh (the mesh route, see the module
    docstring; the two-level round takes its pods from the mesh's ``pod``
    axis), or the device the state must live on (None means CUDA and
    raises without it). On a mesh a batch leaf is either the whole
    (C, ...) batch, the same on every rank, of which each rank takes its
    clients' rows (and, in pod-client mode, its ``data`` shard), or a
    DTensor placed by ``batch_spec``. ``microbatch`` > 1 splits each
    client's batch into that many gradient-accumulation slices (float32
    sums). ``sync_grads``: the SyncSGD baseline, every client steps with
    the clients' mean gradient.
    """
    mesh = mesh_or_device if is_mesh(mesh_or_device) else None
    if mesh is not None:
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(mesh_or_device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    loss_fn = loss_fn or lm_loss
    pod_clients = client_axis == "pod"
    caxes = _axes_tuple(client_axis)
    two_level = inter_reducer is not None
    if two_level:
        if "pod" not in caxes:
            raise ValueError(
                f"inter_reducer={inter_reducer!r} requests the two-level "
                f"sync round, but client_axis={client_axis!r} has no 'pod' "
                f"axis to cross — use client_axis=('pod', 'data')")
        if mesh is not None:
            if "pod" not in mesh.mesh_dim_names:
                raise ValueError(
                    f"inter_reducer={inter_reducer!r} requests the two-level "
                    f"sync round on a mesh with axes "
                    f"{tuple(mesh.mesh_dim_names)}: it has no 'pod' axis")
            n_pods = axis_sizes(mesh)["pod"]
    if mesh is not None:
        missing = [a for a in caxes if a not in mesh.mesh_dim_names]
        if missing:
            raise ValueError(f"client_axis={client_axis!r}: the mesh has no "
                             f"axes {missing}")
        rep_axes = tuple(a for a in mesh.mesh_dim_names if a not in caxes)
        rep_size = math.prod(axis_sizes(mesh)[a] for a in rep_axes)
        rep_mesh = submesh(mesh, rep_axes) if rep_size > 1 else None
        # a pod client's batch shards split over the mesh's `data` axis
        n_data = (axis_sizes(mesh).get("data", 1)
                  if pod_clients and "data" in rep_axes else 1)
    _, update = make_optimizer(optimizer, momentum, weight_decay)

    def opt_update(params, grads, opt_state, eta):
        with layer("local_sgd.update"):
            return update(params, grads, opt_state, eta)

    def value_and_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        with layer("local_sgd.forward"):
            loss = loss_fn(params, cfg, batch)
        with layer("local_sgd.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), treedef.unflatten(list(grads))

    def microbatches(batch):
        if microbatch == 1:
            return [batch]
        mb = tree_leaves(batch)[0].shape[0] // microbatch
        return [tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
                for i in range(microbatch)]

    def accumulate(outs, params):
        """The microbatches' mean loss and gradient (float32 sums), the
        ``(loss, grads)`` pairs of ``outs`` taken one at a time."""
        if microbatch == 1:
            return next(iter(outs))
        loss_acc = 0.0
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for loss, g in outs:
            loss_acc = loss_acc + loss
            g_acc = tree_map(torch.add, g_acc, g)
        inv = 1.0 / microbatch
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

    def shard_grad(params, batch):
        return accumulate((value_and_grad(params, b)
                           for b in microbatches(batch)), params)

    def client_grad(params, batch):
        """(loss, grads) of one client; ``params`` are its row views."""
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        if not pod_clients:
            return shard_grad(live, batch)
        # (data_shards, per_shard, S): SyncSGD within the pod
        outs = [shard_grad(live, _rows(batch, j))
                for j in range(tree_leaves(batch)[0].shape[0])]
        return (torch.mean(torch.stack([l for l, _ in outs])),
                _mean_trees([g for _, g in outs]))

    def per_client_step(params, opt_state, batch, eta):
        loss, grads = client_grad(params, batch)
        opt_update(params, grads, opt_state, eta)
        return params, opt_state, loss

    def check_device(P):
        for t in tree_leaves(P):
            if t.device != dev:
                raise ValueError(f"train step built for {dev}, state on "
                                 f"{t.device}")

    def train_step_local(state, batch, eta):
        P, O = state["params"], state["opt"]
        check_device(P)
        n = tree_leaves(P)[0].shape[0]
        if sync_grads:
            # SyncSGD baseline: every client steps with the mean gradient
            outs = [client_grad(_rows(P, c), _rows(batch, c))
                    for c in range(n)]
            grads = _mean_trees([g for _, g in outs])
            for c in range(n):
                opt_update(_rows(P, c), grads, _rows(O, c), eta)
            losses = [l for l, _ in outs]
        else:
            losses = [per_client_step(_rows(P, c), _rows(O, c),
                                      _rows(batch, c), eta)[2]
                      for c in range(n)]
        # dict(state, ...) keeps extra keys (a compressed round's "comm")
        return dict(state, step=state["step"] + 1), {
            "loss": torch.mean(torch.stack(losses))}

    # -- the mesh route ------------------------------------------------------

    def dtensor_grad(params, placements, batch):
        """(loss, local grads) of one client whose forward runs on
        DTensors over the replica axes: ``params`` its local row blocks,
        ``batch`` its local rows (pod-client mode: this rank's ``data``
        shard)."""
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import \
            implicit_replication

        leaves, treedef = tree_flatten(params)
        live = [from_local(x.detach(), rep_mesh, pl, shape).requires_grad_()
                for x, (pl, shape) in zip(leaves, placements)]
        bpl = tuple(Shard(0) if a == "data" and pod_clients else Replicate()
                    for a in rep_axes)
        if pod_clients:
            # (shards, per_shard, S) → one batch split over `data`
            batch = tree_map(lambda x: x.flatten(0, 1), batch)

        def wrap(x):
            shape = (x.shape[0] * n_data,) + tuple(x.shape[1:])
            return from_local(x.contiguous(), rep_mesh, bpl, shape)

        def one(b):
            with layer("local_sgd.forward"):
                loss = loss_fn(treedef.unflatten(live), cfg,
                               tree_map(wrap, b))
            with layer("local_sgd.backward"):
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach().full_tensor(), treedef.unflatten([
                g.redistribute(rep_mesh, pl).to_local()
                for g, (pl, _) in zip(grads, placements)])

        with mesh_context(mesh), implicit_replication():
            return accumulate(map(one, microbatches(batch)), params)

    def local_batch(batch, group):
        """This rank's (C_local, ...) rows of the batch; in pod-client
        mode (C_local, shards, per_shard, S), its part of the ``data``
        shards."""
        def one(x):
            if is_dtensor(x):
                return x.to_local()
            x = x[group.index * group.n_local:
                  (group.index + 1) * group.n_local]
            if n_data > 1:
                w = x.shape[1] // n_data
                j = mesh.get_local_rank("data")
                x = x[:, j * w:(j + 1) * w]
            return x
        return tree_map(one, batch)

    def mesh_train_step_local(state, batch, eta):
        P, shards = _mesh_shards(state["params"], mesh, caxes)
        O = tree_map(_local, state["opt"])
        check_device(P)
        group = shards[0].clients
        B = local_batch(batch, group)
        names = mesh.mesh_dim_names
        rows = [(tuple(row_placements(sh.placements, len(sh.shape))[
                     names.index(a)] for a in rep_axes), sh.shape[1:])
                for sh in shards]
        if rep_mesh is None:
            grad_of = client_grad
        else:
            grad_of = lambda p, b: dtensor_grad(p, rows, b)
        if sync_grads:
            # SyncSGD baseline: the mean over all C clients' gradients
            outs = [grad_of(_rows(P, c), _rows(B, c))
                    for c in range(group.n_local)]
            grads = tree_map(lambda *gs: group.mean(torch.stack(gs)),
                             *[g for _, g in outs])
            for c in range(group.n_local):
                opt_update(_rows(P, c), grads, _rows(O, c), eta)
            losses = [l for l, _ in outs]
        else:
            # each client's update right after its gradient, as on one
            # device: one client's gradients alive at a time
            losses = []
            for c in range(group.n_local):
                loss, g = grad_of(_rows(P, c), _rows(B, c))
                opt_update(_rows(P, c), g, _rows(O, c), eta)
                losses.append(loss)
        losses = torch.stack(losses)
        loss = (torch.mean(losses) if group.group is None
                else group.sum_scalar(torch.sum(losses)) / group.n_clients)
        return dict(state, step=state["step"] + 1), {"loss": loss}

    if two_level:
        sync_step = build_sync_step(reducer, streaming=streaming,
                                    hierarchical=True, n_pods=n_pods,
                                    inter_reducer=inter_reducer, rng=rng,
                                    mesh=mesh, client_axis=client_axis)
    else:
        sync_step = build_sync_step(reducer, streaming=streaming, rng=rng,
                                    mesh=mesh, client_axis=client_axis)
    if mesh is not None:
        return mesh_train_step_local, sync_step, per_client_step
    return train_step_local, sync_step, per_client_step


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_state(seed: int, cfg: ArchConfig, n_clients: int,
               optimizer: str = "sgd", *, device=None):
    """Training state with ``n_clients`` equal replicas of random params
    (``transformer.init_params(seed=)``, grouped layout) on ``device``
    (None means CUDA)."""
    opt_init, _ = make_optimizer(optimizer)
    params = TF.to_grouped(TF.init_params(cfg, seed=seed, device=device), cfg)
    stacked = tree_broadcast_leading(params, n_clients)
    del params
    # zeros of the stacked shapes: the broadcast of one replica's state
    opt = opt_init(stacked)
    if "t" in opt:
        opt["t"] = torch.zeros((n_clients,), dtype=opt["t"].dtype,
                               device=opt["t"].device)
    return {"params": stacked, "opt": opt, "step": 0}


def init_state_shape(cfg: ArchConfig, n_clients: int, optimizer: str = "sgd"):
    """The state of ``init_state`` as meta tensors: shapes and types only,
    nothing allocated (the reference's ``jax.eval_shape`` of it)."""
    opt_init, _ = make_optimizer(optimizer)
    params = TF.to_grouped(TF.init_params_shape(cfg), cfg)
    stacked = tree_map(lambda x: x.unsqueeze(0).expand(
        (n_clients,) + tuple(x.shape)).contiguous(), params)
    opt = opt_init(stacked)
    if "t" in opt:
        opt["t"] = torch.zeros((n_clients,), dtype=opt["t"].dtype,
                               device="meta")
    return {"params": stacked, "opt": opt, "step": 0}


def batch_spec(cfg: ArchConfig, client_axis, extra_data_axis: bool):
    """The batch's specs: the leading batch dim over the client axes and,
    in pod-client mode, the intra-pod ``data`` axis."""
    axes = list(_axes_tuple(client_axis)) if client_axis else []
    if extra_data_axis:
        axes.append("data")
    lead = tuple(axes) if axes else None
    spec = {"tokens": P(lead, None), "labels": P(lead, None)}
    if cfg.frontend:
        spec["frontend"] = P(lead, None, None)
    return spec


def state_shardings(cfg: ArchConfig, mesh, params_shape, opt_shape,
                    client_axis="data"):
    """The training state's shardings (``NamedSharding``: the mesh, the
    spec and its DTensor placements), the rules' specs made feasible on
    ``mesh``; pod-client mode (``client_axis == "pod"``) adds an FSDP
    split of each replica over the intra-pod ``data`` axis."""
    fsdp = "data" if client_axis == "pod" else None
    pspecs = feasible_specs(
        param_specs(params_shape, client_axis=client_axis, fsdp_axis=fsdp),
        params_shape, mesh)
    ospecs = ({"mu": pspecs} if "mu" in opt_shape else
              {k: (pspecs if k in ("m", "v") else P()) for k in opt_shape})
    to_sh = lambda tree: tree_map(lambda s: NamedSharding(mesh, s), tree)
    return {"params": to_sh(pspecs), "opt": to_sh(ospecs),
            "step": NamedSharding(mesh, P())}


def place_state(state, mesh, client_axis="data", shardings=None):
    """A state of whole tensors (``init_state``, a converted reference
    state, ``gather_state``'s) → DTensors on ``mesh`` placed by
    ``state_shardings`` (or the ``shardings`` given): each rank keeps its
    own block, the same tensors' slices on every rank, no communication
    (a one-rank mesh keeps the tensors themselves). A compressed round's
    ``comm`` state is placed as the mesh round keeps it."""
    if shardings is None:
        shardings = state_shardings(None, mesh, state["params"],
                                    state["opt"], client_axis)

    out = dict(state)
    out["params"] = distribute(state["params"], shardings["params"])
    out["opt"] = distribute(state["opt"], shardings["opt"])
    if state.get("comm") is not None:
        out["comm"] = _place_comm(state["comm"], out["params"], mesh,
                                  client_axis)
    return out


def _place_comm(comm, params, mesh, client_axis):
    """A compressed round's state of whole tensors, in the device route's
    layout → DTensors as the mesh round keeps them: a reducer's ``ref`` a
    row of its leaf, ``res`` as the leaf; a two-level round's inter state
    over ``pod`` and its intra state, one tree a pod, as the (n_pods, ...)
    stack of the pods' refs split over ``pod`` and the pods' residuals
    concatenated, placed as the params."""
    _, shards = _mesh_shards(params, mesh, _axes_tuple(client_axis))
    treedef = tree_flatten(params)[1]

    def put(st, res_shards, refs=None):
        if st is None:
            return None
        ref = treedef.flatten_up_to(st["ref"])
        res = treedef.flatten_up_to(st["res"])
        layouts = _ref_layouts(res_shards, refs)
        return {"ref": treedef.unflatten([place(r, mesh, pl) for r, (pl, _)
                                          in zip(ref, layouts)]),
                "res": treedef.unflatten([place(e, mesh, sh.placements)
                                          for e, sh in zip(res, res_shards)])}

    if "intra" not in comm:
        return put(comm, shards)
    n_pods = len(comm["intra"])
    pods = [over(sh, ("pod",), n_pods) for sh in shards]
    intra = comm["intra"]
    if any(st is not None for st in intra):
        intra = put({"ref": tree_map(lambda *r: torch.stack(r),
                                     *[st["ref"] for st in intra]),
                     "res": tree_map(lambda *e: torch.cat(e),
                                     *[st["res"] for st in intra])},
                    shards, refs=pods)
    return {"intra": intra, "inter": put(comm["inter"], pods)}


def gather_state(state):
    """The whole tensors of a placed state (``full_tensor`` of every
    DTensor leaf, a collective on every rank; on a one-rank mesh the local
    tensors themselves), in the device route's layout: a two-level
    round's intra state one tree a pod."""
    def whole(x):
        if not is_dtensor(x):
            return x
        return x.to_local() if x.device_mesh.size() == 1 else x.full_tensor()

    out = tree_map(whole, state)
    intra = (out.get("comm") or {}).get("intra")
    if isinstance(intra, dict):
        # the (n_pods, ...) refs and the (n, ...) residuals, pod by pod
        n_pods = tree_leaves(intra["ref"])[0].shape[0]
        m = tree_leaves(intra["res"])[0].shape[0] // n_pods
        out["comm"] = dict(out["comm"], intra=tuple(
            {"ref": tree_map(lambda r: r[p], intra["ref"]),
             "res": tree_map(lambda e: e[p * m:(p + 1) * m], intra["res"])}
            for p in range(n_pods)))
    return out
