"""Dry run: trace every (arch × shape × mesh) step on the production mesh
with nothing allocated and no card.

The port of ``src/repro/launch/dryrun.py``. The mesh lives on a ``fake``
process group (``launch.mesh.make_production_mesh``: (16, 16) or
(2, 16, 16) ranks, this process rank 0) and every input is a DTensor
whose local blocks are fake CUDA tensors (``FakeTensorMode``; fake CPU
ones in a build without CUDA, ``fake_device``, with DTensor's CUDA
collectives, ``_fake_mode``): each
program runs once, eagerly, through the card's route — the kernels as
their ``torch.library`` ops (``kernels/trace.py``), DTensor's
collectives recorded by ``launch/collectives.TraceRecorder`` — and its
per-rank memory, FLOPs, bytes and link bytes by mesh axis go into a JSON
record under ``--out``.

Programs per cell:
  train_4k     → local_step   (Local SGD inner step: NO client-axis comm)
                 sync_step    (Alg. 1 line 5: the parameter-averaging round)
                 sync_step_2level (multi-pod: dense over data, int8 over pod)
                 syncsgd_step (baseline: gradients all-reduced every step)
  prefill_32k  → prefill_step
  decode_32k / long_500k → serve_step (one token against a seq_len cache)

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, arch_for_shape
from repro_torch.core import local_sgd as LS
from repro_torch.core import serving as SV
from repro_torch.launch import collectives as CO
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.sharding.rules import axis_sizes
from repro_torch.utils.tree import tree_leaves


def fake_device() -> str:
    """The fake tensors' device: CUDA, or the CPU in a build without CUDA.
    Autograd on a CUDA tensor needs CUDA's device guard and streams,
    which such a build lacks even for a fake tensor; on the CPU the
    kernel wrappers still route a fake tensor to the kernel's op, and
    ``_fake_mode`` gives DTensor the CUDA mesh's collectives, so the
    record is the card's (``chip_smoke.py`` phase 21b traces both devices
    in a CUDA build and holds the records equal)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as a CUDA mesh makes it, one
    ``_dtensor.shard_dim_alltoall`` (a CPU mesh gathers the whole dim and
    keeps a chunk, because gloo has no all-to-all)."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                 shard_dim, group.group_name)


@contextlib.contextmanager
def _fake_mode():
    """``FakeTensorMode`` with DTensor's shard-to-shard move made as on a
    CUDA mesh (``_alltoall``) and its strided-shard size helper run
    outside the mode (the helper lays out index tensors to count a rank's
    elements — metadata that a fake tensor cannot give back as ints)."""
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)
    from torch.distributed.tensor import placement_types as PT

    cls = getattr(PT, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    orig = getattr(cls, name, None)
    if orig is not None:
        @functools.wraps(orig)
        def outside(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        setattr(cls, name, outside)
    orig_a2a = PT.shard_dim_alltoall
    PT.shard_dim_alltoall = _alltoall
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        PT.shard_dim_alltoall = orig_a2a
        if orig is not None:
            setattr(cls, name, orig)


def _analyse(name, run, inputs, mesh, verbose=True):
    """Run ``run()`` once under the recorder and the FLOP counter;
    ``inputs``: the trees whose local blocks are its arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    args = [x.to_local() if hasattr(x, "to_local") else x
            for x in tree_leaves(inputs) if isinstance(x, torch.Tensor)]
    rec = CO.TraceRecorder(mesh, args)
    arg_ptrs = {t.untyped_storage()._cdata for t in args}
    flops = FlopCounterMode(display=False)
    with flops, rec:
        out = run()
    outs = [x.to_local() if hasattr(x, "to_local") else x
            for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
    seen, out_bytes = set(), 0
    for t in outs:
        key = t.untyped_storage()._cdata
        if key not in arg_ptrs and key not in seen:
            seen.add(key)
            out_bytes += t.numel() * t.element_size()
    record = {
        "program": name,
        "memory": CO.memory_summary(rec.argument_bytes, out_bytes,
                                    rec.peak_bytes),
        "cost": CO.cost_summary(flops.get_total_flops(), rec.bytes_accessed),
        "collectives": CO.collective_summary(rec.collectives),
        "kernels": dict(rec.kernels),
    }
    if verbose:
        mem = record["memory"]
        print(f"  [{name}] peak_bytes/rank={mem['peak_bytes']} "
              f"flops={record['cost']['flops']:.3e} "
              f"bytes={record['cost']['bytes_accessed']:.3e} "
              f"coll_link_bytes="
              f"{record['collectives']['total_link_bytes']:.3e} "
              f"by_axes={record['collectives']['by_axes']}", flush=True)
    return record


def dryrun_cell(arch: str, shape_name: str, mesh, *, verbose=True,
                hierarchical=False, microbatch=4, programs=None,
                overrides=None, donate=False):
    """Trace every program of one (arch, shape, mesh) cell once."""
    t0 = time.time()
    shape = SHAPES[shape_name]
    cfg = arch_for_shape(arch, shape_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    if shape.mode == "train":
        records = trace_train(cfg, shape, mesh, hierarchical=hierarchical,
                              microbatch=microbatch, programs=programs,
                              verbose=verbose)
    else:
        records = trace_serve(cfg, shape, mesh, programs=programs,
                              verbose=verbose)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": axis_sizes(mesh),
        "device": mesh.device_type,
        "hierarchical": hierarchical,
        "arch_variant": cfg.name,
        "donate": donate,   # the port's steps update in place regardless
        "elapsed_s": round(time.time() - t0, 1),
        "programs": records,
    }


def trace_train(cfg, shape, mesh, *, client_axis=None, hierarchical=False,
                microbatch=4, programs=None, verbose=True):
    """The training programs' records for ``cfg`` at ``shape`` on the
    fake ``mesh`` (``hierarchical``: pod clients on a multi-pod mesh)."""
    want = lambda p: programs is None or p in programs
    if hierarchical and "pod" in mesh.mesh_dim_names:
        client_axis = "pod"
    records = []
    with mesh_context(mesh), _fake_mode():
        state_s, batch_s, st_sh, b_sh, client_axis = SP.train_specs(
            cfg, shape, mesh, client_axis=client_axis)
        state = SP.local_inputs(state_s, st_sh, mesh.device_type)
        batch = SP.local_inputs(batch_s, b_sh, mesh.device_type)
        local_step, sync_step, _ = LS.build_train_steps(
            cfg, mesh, client_axis=client_axis, microbatch=microbatch)
        if want("local_step"):
            records.append(_analyse(
                "local_step", lambda: local_step(state, batch, 0.1),
                (state, batch), mesh, verbose))
        if want("sync_step"):
            records.append(_analyse("sync_step", lambda: sync_step(state),
                                    state, mesh, verbose))
        # multi-pod meshes also trace the two-level round: dense
        # intra-pod (data axis), int8 inter-pod (pod axis)
        if (want("sync_step_2level") and "pod" in mesh.mesh_dim_names
                and client_axis != "pod"):
            s2 = LS.build_sync_step(
                "dense", hierarchical=True,
                n_pods=axis_sizes(mesh)["pod"], inter_reducer="int8",
                mesh=mesh, client_axis=client_axis)
            records.append(_analyse("sync_step_2level", lambda: s2(state),
                                    state, mesh, verbose))
        if want("syncsgd_step"):
            syncsgd_step, _, _ = LS.build_train_steps(
                cfg, mesh, client_axis=client_axis, microbatch=microbatch,
                sync_grads=True)
            records.append(_analyse(
                "syncsgd_step", lambda: syncsgd_step(state, batch, 0.1),
                (state, batch), mesh, verbose))
    return records


def trace_serve(cfg, shape, mesh, *, programs=None, verbose=True):
    """The serving program's record (``prefill_step`` for a prefill
    shape, else ``serve_step``) for ``cfg`` at ``shape`` on ``mesh``."""
    name = "prefill_step" if shape.mode == "prefill" else "serve_step"
    if programs is not None and name not in programs:
        return []
    with mesh_context(mesh), _fake_mode():
        sp = SP.serve_specs(cfg, shape, mesh)
        dev = mesh.device_type
        args = [SP.local_inputs(sp[k], sp[k + "_sh"], dev)
                for k in ("params", "cache", "tokens")]
        if name == "prefill_step":
            step = SV.build_prefill_step(cfg)
            if cfg.frontend:
                args.append(SP.local_inputs(sp["frontend"],
                                            sp["frontend_sh"], dev))
        else:
            step = SV.build_serve_step(cfg)
        return [_analyse(name, lambda: _no_grad(step, *args), tuple(args),
                         mesh, verbose)]


def _no_grad(fn, *args):
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.no_grad(), implicit_replication():
        return fn(*args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--hierarchical", action="store_true",
                    help="pod-level clients (beyond-paper mode)")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--programs", default=None, help="comma-sep subset")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache variant")
    ap.add_argument("--donate", action="store_true",
                    help="kept for the reference's flag: the port's steps "
                         "update the state and cache in place always")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=fake_device())
    tag = "multipod" if args.multi_pod else "singlepod"
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        print(f"=== dryrun {arch} × {shape} × {tag} ===", flush=True)
        try:
            rec = dryrun_cell(
                arch, shape, mesh, hierarchical=args.hierarchical,
                microbatch=args.microbatch,
                programs=(args.programs.split(",") if args.programs
                          else None),
                overrides={"kv_quant": True} if args.kv_int8 else None,
                donate=args.donate)
            suffix = (("_hier" if args.hierarchical else "")
                      + ("_kvint8" if args.kv_int8 else "")
                      + ("_donate" if args.donate else ""))
            fname = f"{args.out}/{arch}_{shape}_{tag}{suffix}.json"
            with open(fname, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"  -> {fname} ({rec['elapsed_s']}s)", flush=True)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("ALL CELLS OK")


if __name__ == "__main__":
    main()
