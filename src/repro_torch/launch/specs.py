"""Shape-only inputs and their shardings for every (arch × shape × mesh).

The port of ``src/repro/launch/specs.py``. ``input_specs`` gives meta
tensors (shapes and types, nothing allocated) and the ``NamedSharding``
of each; ``local_inputs`` turns them, under ``FakeTensorMode``, into
DTensors whose local blocks are fake tensors of each rank's shape — what
the dry run traces a step on.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs import SHAPES, arch_for_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import local_sgd as LS
from repro_torch.models import transformer as TF
from repro_torch.sharding.rules import (NamedSharding, P, axis_sizes,
                                        distribute, is_dtensor)
from repro_torch.utils.tree import tree_leaves, tree_map


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def client_axes_for(mesh) -> Tuple[str, ...]:
    """Paper-faithful client axes: every non-model axis (pod×data
    clients)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def n_clients_for(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in client_axes_for(mesh))


def train_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                client_axis=None, optimizer: str = "sgd"):
    """Returns (state_shapes, batch_shapes, state_shardings,
    batch_shardings, client_axis); tokens and labels are int64, as the
    port's batches are."""
    client_axis = client_axis or client_axes_for(mesh)
    if isinstance(client_axis, str):
        client_axis = (client_axis,)
    sizes = axis_sizes(mesh)
    C = math.prod(sizes[a] for a in client_axis)

    state = LS.init_state_shape(cfg, C, optimizer)
    B, S = shape.global_batch, shape.seq_len
    assert B % C == 0, (B, C)
    S_text = S - (cfg.n_frontend_tokens if cfg.frontend else 0)
    if tuple(client_axis) == ("pod",):
        # per-pod clients: the batch further split over the intra-pod data
        # axis (SyncSGD within the pod) — (pod, data, b, S)
        n_data = sizes["data"]
        assert B % (C * n_data) == 0, (B, C, n_data)
        lead_shape = (C, n_data, B // (C * n_data))
        lead_spec = ("pod", "data", None)
    else:
        lead_shape = (C, B // C)
        lead_spec = (client_axis, None)
    batch = {"tokens": _meta(lead_shape + (S_text,), torch.long),
             "labels": _meta(lead_shape + (S_text,), torch.long)}
    if cfg.frontend:
        batch["frontend"] = _meta(
            lead_shape + (cfg.n_frontend_tokens, cfg.frontend_dim),
            torch.bfloat16)

    ca = client_axis if len(client_axis) > 1 else client_axis[0]
    st_sh = LS.state_shardings(cfg, mesh, state["params"], state["opt"], ca)
    b_sh = {k: NamedSharding(mesh, P(*lead_spec, *(None,) * (v.ndim - 2)))
            for k, v in batch.items()}
    return state, batch, st_sh, b_sh, ca


def serve_specs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Returns the params', cache's and tokens' shapes and shardings (and
    a frontend arch's prefill embeddings')."""
    from repro_torch.core.serving import serve_shardings

    B, S = shape.global_batch, shape.seq_len
    params = TF.init_params_shape(cfg)
    cache = TF.init_cache_shape(cfg, B, S)
    data_axes = client_axes_for(mesh)
    n_data = math.prod(axis_sizes(mesh)[a] for a in data_axes)
    if B % n_data == 0:
        batch_axes, seq_axes = data_axes, ()
    else:
        # batch too small to split (long_500k): sequence-split the cache
        batch_axes, seq_axes = (), data_axes
    params_sh, cache_sh, tokens_sh = serve_shardings(
        cfg, mesh, params, cache, data_axes=batch_axes, seq_axes=seq_axes)
    if shape.mode == "decode":
        tokens = _meta((B, 1), torch.long)
    else:
        S_text = S - (cfg.n_frontend_tokens if cfg.frontend else 0)
        tokens = _meta((B, S_text), torch.long)
    out = {"params": params, "cache": cache, "tokens": tokens,
           "params_sh": params_sh, "cache_sh": cache_sh,
           "tokens_sh": tokens_sh}
    if shape.mode == "prefill" and cfg.frontend:
        out["frontend"] = _meta((B, cfg.n_frontend_tokens, cfg.frontend_dim),
                                torch.bfloat16)
        out["frontend_sh"] = NamedSharding(
            mesh, P(batch_axes if batch_axes else None, None, None))
    return out


def input_specs(arch_name: str, shape_name: str, mesh, overrides=None, **kw):
    """Unified entry: abstract inputs + shardings for one matrix cell."""
    shape = SHAPES[shape_name]
    cfg = arch_for_shape(arch_name, shape_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    if shape.mode == "train":
        return ("train", cfg, *train_specs(cfg, shape, mesh, **kw))
    return ("serve", cfg, serve_specs(cfg, shape, mesh))


def local_inputs(shapes, shardings, device):
    """Meta tensors and their shardings → DTensors whose local blocks are
    tensors of each rank's shape on ``device`` (fake tensors under
    ``FakeTensorMode``: nothing is allocated). The state's ``step`` and
    other non-tensors pass through."""
    return distribute(tree_map(
        lambda x: (torch.empty(x.shape, dtype=x.dtype, device=device)
                   if isinstance(x, torch.Tensor) else x), shapes),
        shardings)


def local_bytes(tree) -> int:
    """The bytes of a tree's local blocks on this rank."""
    total = 0
    for x in tree_leaves(tree):
        t = x.to_local() if is_dtensor(x) else x
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
