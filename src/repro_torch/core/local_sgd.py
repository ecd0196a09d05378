"""Local-SGD step builders for transformer training, the clients on one
device.

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
tensors in place and return the state. The reference's ``mesh`` argument
becomes ``device``; what needs a device mesh (``batch_spec``,
``state_shardings``, ``init_state_shape``) raises until sharded training
is ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.comm import get_reducer
from repro_torch.comm.reducer import DenseMean, reduce_streaming
from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulate import _copy_broadcast_, resolve_device
from repro_torch.engine.topology import Hierarchical
from repro_torch.models import transformer as TF
from repro_torch.optim import make_optimizer
from repro_torch.utils.rng import TorchKey
from repro_torch.utils.tree import (tree_broadcast_leading, tree_flatten,
                                    tree_leaves, tree_map, tree_mean_leading)


def _needs_mesh(what: str):
    return NotImplementedError(
        f"{what} needs a device mesh, which is not ported yet (ROADMAP "
        f"queue 1: sharded training)")


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


def build_sync_step(reducer=None, *, base_seed: int = 0,
                    streaming: bool = False, hierarchical: bool = False,
                    n_pods: int = 2, inter_reducer="int8", rng=None):
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
    """
    reducer = get_reducer(reducer)
    dense = isinstance(reducer, DenseMean)

    if hierarchical:
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        if n_pods > 1:
            return _build_two_level_sync_step(reducer, n_pods, inter_reducer,
                                              base_seed, streaming, rng)
        # one pod has no inter-pod hop: the flat round with the intra
        # reducer

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
            consensus, comm = reduce_streaming(reducer, params, comm, key)
        else:
            consensus, comm = reducer.reduce(params, comm, key)
        return _finish_round(state, consensus, comm=comm)

    # the tags StagewiseDriver prices the round by
    sync_step.reducer = reducer
    sync_step.streaming = streaming
    sync_step.hierarchical = False
    return sync_step


def _build_two_level_sync_step(intra, n_pods: int, inter_reducer,
                               base_seed: int, streaming: bool, rng):
    """The hierarchical (n_pods > 1) round behind ``build_sync_step``: one
    ``Hierarchical.reduce`` a sync, the per-hop reducer state in
    ``state["comm"]`` (none for dense∘dense, as the flat dense round)."""
    topo = Hierarchical(n_pods=n_pods, intra=intra,
                        inter=get_reducer(inter_reducer), streaming=streaming)

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


def build_train_steps(cfg: ArchConfig, device=None, *,
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

    ``device``: where the state must live (None means CUDA and raises
    without it). ``microbatch`` > 1 splits each client's batch into that
    many gradient-accumulation slices (float32 sums). ``sync_grads``: the
    SyncSGD baseline, every client steps with the clients' mean gradient.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    loss_fn = loss_fn or lm_loss
    pod_clients = client_axis == "pod"
    two_level = inter_reducer is not None
    if two_level:
        axes = (client_axis if isinstance(client_axis, (tuple, list))
                else (client_axis,))
        if "pod" not in axes:
            raise ValueError(
                f"inter_reducer={inter_reducer!r} requests the two-level "
                f"sync round, but client_axis={client_axis!r} has no 'pod' "
                f"axis to cross — use client_axis=('pod', 'data')")
    _, opt_update = make_optimizer(optimizer, momentum, weight_decay)

    def value_and_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        loss = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), treedef.unflatten(list(grads))

    def shard_grad(params, batch):
        if microbatch == 1:
            return value_and_grad(params, batch)
        loss_acc = 0.0
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        mb = tree_leaves(batch)[0].shape[0] // microbatch
        for i in range(microbatch):
            loss, g = value_and_grad(
                params, tree_map(lambda x: x[i * mb:(i + 1) * mb], batch))
            loss_acc = loss_acc + loss
            g_acc = tree_map(torch.add, g_acc, g)
        inv = 1.0 / microbatch
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

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

    def train_step_local(state, batch, eta):
        P, O = state["params"], state["opt"]
        for t in tree_leaves(P):
            if t.device != dev:
                raise ValueError(f"train step built for {dev}, state on "
                                 f"{t.device}")
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

    sync_step = (build_sync_step(reducer, streaming=streaming,
                                 hierarchical=True, n_pods=n_pods,
                                 inter_reducer=inter_reducer, rng=rng)
                 if two_level else
                 build_sync_step(reducer, streaming=streaming, rng=rng))
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


def batch_spec(cfg: ArchConfig, client_axis, extra_data_axis: bool):
    raise _needs_mesh("batch_spec")


def state_shardings(cfg: ArchConfig, mesh, params_shape, opt_shape,
                    client_axis: str = "data"):
    raise _needs_mesh("state_shardings")


def init_state_shape(cfg: ArchConfig, n_clients: int, optimizer: str = "sgd"):
    raise _needs_mesh("init_state_shape")
