"""The port's dry run (``launch/dryrun.py``) against the reference's
assertions on its compiled programs.

Everything runs in this process on a ``fake`` process group: the inputs
are DTensors over fake tensors (CPU ones in this build without CUDA,
with DTensor's CUDA collectives), nothing is allocated and nothing moves.
On a fake (data=2, model=4) mesh the four archs of
``tests/test_dryrun_integration.py`` (SMOKE, 128 tokens, a global batch
of 8, microbatch 2) give a local step with under 1e5 link bytes on
``data`` (the loss metric's scalar) and a sync round with over 1e5:
exactly 2·(n−1)/n times a rank's replica in float32 (its params' and
moments' local blocks, computed here from the specs by hand), and the
same link bytes as the reference's sync round compiled on 8 host
devices; the local step's peak holds a hand-computed floor; the kernels
run as their ops (``kernels/trace.py``), never their plain versions. On
a fake (pod=2, data=2, model=2) mesh the two-level round has traffic on
``data`` alone and on ``pod`` alone, the flat round none on ``pod``
alone, as the reference's two-level collective test asserts of its
HLO. The link factors are the reference's
(``hlo_analysis.parse_collectives``) on hand-made collectives. Serving
traces (prefill, decode, the sequence-split
long_500k cache) run for the four archs.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import hlo_analysis as H
from repro_torch.configs import SHAPES, get_arch
from repro_torch.core import local_sgd as TLS
from repro_torch.launch import collectives as CO
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.sharding.rules import axis_sizes
from repro_torch.utils.tree import tree_leaves

ARCHS = ["qwen3-14b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
         "recurrentgemma-2b"]
TRAIN = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)


@pytest.fixture(autouse=True, scope="module")
def _fake_group():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return make_fake_mesh(shape, axes, DR.fake_device())


def _by_axes(rec, pred):
    return sum(v for k, v in rec["collectives"]["by_axes"].items()
               if pred(k.split("+")))


def _replica_bytes(cfg, mesh, ca, itemsize=None, parts=("params", "opt")):
    """One client's params + moments on one rank, from the specs by hand:
    each dim divided by the sizes of the mesh axes its entry names
    (``itemsize``: bytes an element, else the leaf's own)."""
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in ((ca,) if isinstance(ca, str) else ca))
    state = TLS.init_state_shape(cfg, n)
    sh = TLS.state_shardings(cfg, mesh, state["params"], state["opt"], ca)
    total = 0
    for part in parts:
        for x, s in zip(tree_leaves(state[part]), tree_leaves(sh[part])):
            shape = list(x.shape)
            for d, e in enumerate(s.spec):
                axes = e if isinstance(e, tuple) else (() if e is None
                                                       else (e,))
                for a in axes:
                    assert shape[d] % sizes[a] == 0
                    shape[d] //= sizes[a]
            assert shape[0] == 1   # one client a rank
            total += math.prod(shape) * (itemsize or x.element_size())
    return total


@pytest.fixture(scope="module")
def train_records():
    mesh = _mesh((2, 4))
    return {a: DR.trace_train(get_arch(a, smoke=True), TRAIN, mesh,
                              microbatch=2, verbose=False,
                              programs=["local_step", "sync_step"])
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_step_has_no_client_axis_traffic(train_records, arch):
    local, sync = train_records[arch]
    assert local["program"] == "local_step"
    assert _by_axes(local, lambda a: "data" in a) < 1e5, local
    assert _by_axes(sync, lambda a: "data" in a) > 1e5, sync


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_round_moves_the_replica_exactly(train_records, arch):
    mesh = _mesh((2, 4))
    cfg = get_arch(arch, smoke=True)
    replica = _replica_bytes(cfg, mesh, "data")
    _, sync = train_records[arch]
    n = 2
    # the mean is summed and all-reduced in float32, whatever the leaf's
    # type (as jnp.mean upcasts a bf16 leaf)
    assert sync["collectives"]["by_axes"] == {
        "data": 2 * (n - 1) / n * _replica_bytes(cfg, mesh, "data", 4)}
    assert set(sync["collectives"]["by_kind"]) == {"all-reduce"}
    # its arguments: the state's local blocks (one client a rank)
    assert sync["memory"]["argument_bytes"] == replica
    assert sync["memory"]["peak_bytes"] >= replica


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_moves_are_all_to_alls(train_records, arch):
    """DTensor moves a shard between tensor dims with one all-to-all, as
    on a CUDA mesh (a CPU mesh alone would gather the dim instead)."""
    local, _ = train_records[arch]
    assert local["collectives"]["by_kind"].get("all-to-all", 0) > 0, local


@pytest.mark.parametrize("arch", ARCHS)
def test_local_step_peak_holds_what_must_be_alive(train_records, arch):
    """A hand-computed floor of the local step's per-rank peak: its
    arguments, the float32 sum of the first microbatch's gradient (the
    client's params' local blocks) and one microbatch's float32
    log-probabilities over the whole vocabulary (the logits gathered
    from their vocab split), all alive in the second microbatch's
    loss."""
    mesh = _mesh((2, 4))
    cfg = get_arch(arch, smoke=True)
    local, _ = train_records[arch]
    rows = TRAIN.global_batch // 2 // 2   # a rank's client, a microbatch
    floor = (local["memory"]["argument_bytes"]
             + _replica_bytes(cfg, mesh, "data", 4, parts=("params",))
             + rows * TRAIN.seq_len * cfg.vocab_size * 4)
    assert local["memory"]["peak_bytes"] >= floor, (local["memory"], floor)


_REF_SYNC = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax
from repro.configs import get_arch, SHAPES
from repro.core import local_sgd as LS
from repro.launch import specs as SP
from repro.launch import hlo_analysis as H
from repro.launch.mesh import _make_mesh, mesh_context

mesh = _make_mesh((2, 4), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
out = {}
for arch in sys.argv[1:]:
    cfg = get_arch(arch, smoke=True)
    state, batch, st_sh, b_sh, ca = SP.train_specs(cfg, shape, mesh)
    with mesh_context(mesh):
        _, sync_step, _ = LS.build_train_steps(cfg, mesh, client_axis=ca,
                                               microbatch=2)
        cs = jax.jit(sync_step, in_shardings=(st_sh,),
                     out_shardings=st_sh).lower(state).compile()
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out[arch] = H.collective_summary(
        H.parse_collectives_nested(cs.as_text(), sizes))
print(json.dumps(out))
"""


def test_sync_round_link_bytes_equal_the_reference(train_records):
    """The reference's sync round compiled on 8 host devices (a
    subprocess): the same link bytes by axis and kind as the port's."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SYNC, *ARCHS],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    for arch in ARCHS:
        port = train_records[arch][1]["collectives"]
        assert port["by_axes"] == ref[arch]["by_axes"], arch
        assert port["by_kind"] == ref[arch]["by_kind"], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_the_trace_runs_the_kernels_as_ops(train_records, arch):
    local, _ = train_records[arch]
    want = {"fused_sgd_update_"}
    want.add("ssd" if arch.startswith("mamba2") else "flash_attention")
    assert want <= set(local["kernels"]), local["kernels"]
    # one multi-leaf update a client a local step (two type groups where
    # float32 leaves sit beside bf16 ones: one op call covers both)
    assert local["kernels"]["fused_sgd_update_"] == 1
    assert local["cost"]["flops"] > 0


def test_two_level_round_splits_traffic_by_axis():
    mesh = _mesh((2, 2, 2))
    cfg = get_arch("qwen3-14b", smoke=True)
    recs = {r["program"]: r for r in DR.trace_train(
        cfg, TRAIN, mesh, microbatch=2, verbose=False,
        programs=["local_step", "sync_step", "sync_step_2level"])}
    hier, flat = recs["sync_step_2level"], recs["sync_step"]
    assert _by_axes(hier, lambda a: a == ["data"]) > 0
    assert _by_axes(hier, lambda a: a == ["pod"]) > 0
    assert _by_axes(flat, lambda a: a == ["pod"]) == 0
    assert _by_axes(flat, lambda a: "pod" in a and "data" in a) > 0
    # the local step: client-grid traffic is the loss scalar only
    assert _by_axes(recs["local_step"],
                    lambda a: "pod" in a or "data" in a) < 1e5
    # the inter hop's int8 codes and scales over pod: the quantize and
    # dequant_mean ops on every leaf
    assert hier["kernels"]["quantize"] == hier["kernels"]["dequant_mean"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
def test_serving_programs_trace(arch, shape):
    base = SHAPES[shape]
    sh = dataclasses.replace(base, seq_len=min(base.seq_len, 256),
                             global_batch=min(base.global_batch, 8))
    (rec,) = DR.trace_serve(get_arch(arch, smoke=True), sh, _mesh((2, 4)),
                            verbose=False)
    assert rec["program"] == ("prefill_step" if shape == "prefill_32k"
                              else "serve_step")
    assert rec["memory"]["argument_bytes"] > 0
    if shape == "prefill_32k":
        kernel = "ssd" if arch.startswith("mamba2") else "flash_attention"
        assert rec["kernels"].get(kernel, 0) > 0


def test_link_factors_are_the_reference_ones():
    """Hand-made collectives: the reference's parser (its factors) and the
    port's ``link_bytes`` / ``collective_summary`` agree."""
    mesh_shape = {"data": 2, "model": 4}
    lines = {
        "all-reduce": "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), "
                      "replica_groups={{0,4}}, to_apply=%add",
        "all-gather": "%ag = bf16[8,64]{1,0} all-gather(bf16[2,64]{1,0} "
                      "%p), replica_groups={{0,1,2,3}}, dimensions={0}",
        "reduce-scatter": "%rs = f32[16]{0} reduce-scatter(f32[64]{0} %p),"
                          " replica_groups={{0,1,2,3}}, dimensions={0}, "
                          "to_apply=%add",
        "all-to-all": "%aa = f32[4,8]{1,0} all-to-all(f32[4,8]{1,0} %p), "
                      "replica_groups={{0,4}}, dimensions={0}",
        "collective-permute": "%cp = f32[32]{0} collective-permute("
                              "f32[32]{0} %p), source_target_pairs="
                              "{{0,1},{1,0}}",
    }
    ref = []
    for kind, line in lines.items():
        (c,) = H.parse_collectives(line, mesh_shape)
        assert c["kind"] == kind
        got = CO.link_bytes(kind, c["bytes"], c["group_size"])
        assert got == pytest.approx(c["link_bytes"], rel=1e-12), kind
        ref.append(c)
    port = [dict(c, link_bytes=CO.link_bytes(c["kind"], c["bytes"],
                                             c["group_size"]))
            for c in ref]
    assert CO.collective_summary(port) == H.collective_summary(ref)


def test_cli_writes_the_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the production (16, 16)
    mesh at full width (the sync round: the cheapest program)."""
    DR.main(["--arch", "qwen3-14b", "--shape", "train_4k", "--out",
             str(tmp_path), "--programs", "sync_step"])
    (f,) = tmp_path.glob("*.json")
    rec = json.loads(f.read_text())
    assert f.name == "qwen3-14b_train_4k_singlepod.json"
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["device"] == DR.fake_device()
    (sync,) = rec["programs"]
    # qwen3-14b's full state on 16 model ranks, one client a rank
    assert sync["memory"]["argument_bytes"] > 5e9
    assert set(sync["collectives"]["by_axes"]) == {"data"}
