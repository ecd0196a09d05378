"""The port's sharding rules against the JAX package's, entry by entry.

Leaves are every arch's params, SMOKE and full width: the port's as meta
tensors (``init_params_shape`` / ``init_state_shape``, the grouped
layout), the reference's from ``jax.eval_shape``. ``param_specs`` plain,
with a client axis and with an FSDP axis; ``feasible_specs`` on the
production (16, 16) and (2, 16, 16) meshes (their axis names and sizes
are all either side reads); ``cache_specs`` leaf name by leaf name (the
reference stacks a cache over layer groups, the port keeps one per
layer); ``to_placements`` and ``shard`` off a mesh. Nothing here starts a
process group.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_arch as jax_get_arch
from repro.core import local_sgd as JLS
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch.configs import get_arch
from repro_torch.core import local_sgd as TLS
from repro_torch.models import transformer as TF
from repro_torch.sharding import rules as TR
from repro_torch.sharding.rules import P
from repro_torch.utils.tree import tree_flatten_with_path

MODES = {  # name: (n_clients or None, client_axis, fsdp_axis)
    "plain": (None, None, None),
    "data": (2, "data", None),
    "pod-data": (4, ("pod", "data"), None),
    "pod-fsdp": (2, "pod", "data"),
}
MESHES = {"single-pod": ((16, 16), ("data", "model")),
          "multi-pod": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_pairs(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]]


@functools.lru_cache(maxsize=None)
def _shapes(arch, smoke, n):
    jcfg, tcfg = jax_get_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)
    if n is None:
        return (JT.init_params_shape(jcfg),
                TF.to_grouped(TF.init_params_shape(tcfg), tcfg))
    return (JLS.init_state_shape(jcfg, n)["params"],
            TLS.init_state_shape(tcfg, n)["params"])


def _equal(port_specs, jax_specs):
    got = tree_flatten_with_path(port_specs)[0]
    want = _jax_pairs(jax_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a == P(*b), (path, a, b)
    return len(got)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_the_reference(arch, mode, smoke):
    n, ca, fsdp = MODES[mode]
    jshape, tshape = _shapes(arch, smoke, n)
    for a, b in zip(tree_flatten_with_path(tshape)[0], _jax_pairs(jshape)):
        assert tuple(a[1].shape) == tuple(b[1].shape), a[0]
    assert _equal(TR.param_specs(tshape, client_axis=ca, fsdp_axis=fsdp),
                  JR.param_specs(jshape, client_axis=ca, fsdp_axis=fsdp)) > 3


def _on(mesh, mode):
    ca = MODES[mode][1]
    axes = MESHES[mesh][1]
    return ca is None or all(a in axes for a in
                             ((ca,) if isinstance(ca, str) else ca))


@pytest.mark.parametrize("mesh,mode", [(m, o) for m in MESHES
                                       for o in MODES if _on(m, o)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_feasible_specs_match_the_reference(arch, mode, mesh):
    shape, axes = MESHES[mesh]
    n, ca, fsdp = MODES[mode]
    jshape, tshape = _shapes(arch, False, n)
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    tmesh = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    got = TR.feasible_specs(TR.param_specs(tshape, ca, fsdp), tshape, tmesh)
    want = JR.feasible_specs(JR.param_specs(jshape, ca, fsdp), jshape, jmesh)
    _equal(got, want)


CACHE_AXES = {"batch": (("data",), ()), "pod-batch": (("pod", "data"), ()),
              "sequence": ((), ("data",))}


@pytest.mark.parametrize("axes", list(CACHE_AXES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_the_reference_by_leaf_name(arch, axes):
    data_axes, seq_axes = CACHE_AXES[axes]
    jcfg, tcfg = jax_get_arch(arch, smoke=True), get_arch(arch, smoke=True)
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    tcache = TF.init_cache_shape(tcfg, 2, 16)
    want = {}
    for path, spec in _jax_pairs(JR.cache_specs(jcache, data_axes,
                                                seq_axes)):
        want.setdefault(TR.leaf_name(path), set()).add(P(*spec))
    got = {}
    tspecs = TR.cache_specs(tcache, data_axes, seq_axes)
    for (path, spec), (_, leaf) in zip(tree_flatten_with_path(tspecs)[0],
                                       tree_flatten_with_path(tcache)[0]):
        assert len(spec) == leaf.ndim or spec == P(), path
        got.setdefault(TR.leaf_name(path), set()).add(spec)
    assert sorted(got) == sorted(want)
    for name in got:
        if name == "pos":   # a scalar there, one position a row here
            assert got[name] == {P()} == want[name]
            continue
        # the reference's leading group dims are unsplit: the trailing
        # entries must agree
        for spec in got[name]:
            assert any(tuple(w)[len(tuple(w)) - len(spec):] == tuple(spec)
                       and all(e is None
                               for e in tuple(w)[:len(tuple(w)) - len(spec)])
                       for w in want[name]), (name, spec, want[name])


def test_to_placements_is_pod_major_and_one_a_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TR.to_placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TR.to_placements(P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert TR.to_placements(P(), mesh) == (Replicate(),) * 3


def test_specs_normalise_as_the_reference_does():
    assert P(("data",), None) == P("data", None) == P(*JR.P(("data",),
                                                             None))
    assert P((), "model") == P(None, "model")


def test_shard_is_a_no_op_off_a_mesh_and_on_a_plain_tensor():
    x = torch.zeros(2, 3, 4)
    assert TR.shard(x, None, None, "model") is x
    with TR.mesh_context(SimpleNamespace(mesh_dim_names=("data", "model"),
                                         shape=(2, 2))):
        assert TR.active_mesh() is not None
        assert TR.shard(x, None, None, "model") is x
    assert TR.active_mesh() is None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_shardings_are_the_feasible_rules(arch):
    """``state_shardings``: the params' and moments' specs are the rules'
    made feasible on the mesh (pod clients: FSDP on data)."""
    tcfg = get_arch(arch)
    shape, axes = MESHES["multi-pod"]
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    for ca, fsdp in (("data", None), (("pod", "data"), None),
                     ("pod", "data")):
        state = TLS.init_state_shape(tcfg, 4)
        sh = TLS.state_shardings(tcfg, mesh, state["params"], state["opt"],
                                 ca)
        want = TR.feasible_specs(TR.param_specs(state["params"], ca, fsdp),
                                 state["params"], mesh)
        for part in (sh["params"], sh["opt"]["mu"]):
            got = tree_flatten_with_path(part)[0]
            assert [s.spec for _, s in got] == [
                s for _, s in tree_flatten_with_path(want)[0]]
        assert sh["step"].spec == P()
