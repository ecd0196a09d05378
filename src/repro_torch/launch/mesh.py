"""Device meshes: the host meshes the launchers and tests run on, and the
production meshes the dry run traces.

The port of ``src/repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names and order, ranks laid out row-major as ``jax.make_mesh`` lays out
devices:

single-pod: (16, 16)    axes (data, model)       — 256 ranks
multi-pod : (2, 16, 16) axes (pod, data, model)  — 512 ranks, pod-major

  pod    inter-pod axis, the hop the two-level sync round
         (``core.local_sgd.build_sync_step(hierarchical=True)``) crosses
         once per round;
  data   intra-pod client/batch axis: the paper's N clients live on the
         (pod × data) grid pod-major, so a client dim split over
         ``("pod", "data")`` puts each pod's clients on one contiguous
         slice;
  model  tensor-parallel axis (heads / ffn / experts / vocab).

``make_host_mesh`` and ``make_host_pod_mesh`` run on the process group
the caller started (``torch.distributed.init_process_group`` with its
world size and rank), or, for a one-rank mesh with no group yet, on a
world-1 group they start themselves (NCCL on the card, gloo on the CPU);
nothing switches backend or device when NCCL fails. The production
meshes live on a ``fake`` process group (``make_fake_mesh``): nothing is
communicated and the dry run allocates nothing.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.simulate import resolve_device
from repro_torch.sharding.rules import mesh_context  # noqa: F401 (re-export)

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and the HBM3
# rate; the roofline of the dry run and the serving engine's DeviceModel.
# The modeled links (ICI/WAN presets) are in ``comm/cost.py``.
H100_PEAK_FLOPS_BF16 = 989e12   # FLOP/s
H100_HBM_BW = 3.35e12           # B/s


def _device_mesh(device_type: str, shape, axes) -> DeviceMesh:
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def _host_mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {dict(zip(axes, shape))} mesh needs a process group of "
                f"{math.prod(shape)} ranks: call "
                f"torch.distributed.init_process_group first")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() == "fake":
        raise RuntimeError("a host mesh on a fake process group: the fake "
                           "group is the dry run's (make_fake_mesh)")
    return _device_mesh(dev.type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh on the caller's process group; ``device``: the
    ranks' device type (None means CUDA and raises without it)."""
    return _host_mesh((data, model), ("data", "model"), device)


def make_host_pod_mesh(pods: int = 2, data: int = 1, model: int = 1,
                       device=None):
    """A (pod, data, model) mesh: the miniature of the multi-pod
    production mesh, same axis names (needs pods·data·model ranks)."""
    return _host_mesh((pods, data, model), ("pod", "data", "model"), device)


def make_fake_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh on a ``fake`` process group of prod(shape) ranks, this
    process rank 0: collectives are recorded by a dispatch mode and move
    nothing. Replaces an earlier fake group of another size; refuses to
    replace a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; the fake "
                               "mesh needs a process of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return _device_mesh(device_type, shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes, device_type)

