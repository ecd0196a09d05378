"""The port's trees, reducers, topologies, registry and cost ledger against
the JAX package's.

The same numpy stacked replicas and the same random bits (a ``JaxKey``
that replays ``fold_in(rng, leaf)`` then ``jax.random.bits``) go through
both packages. Consensus and error-feedback state agree to 1e-6: the mean
over clients sums in a different order in the two frameworks; everything
before it (delta, scale, codes, dequantized message) is computed in the
same float32 op order. Within the port StreamingStar equals Star exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, to_numpy_tree
from repro.comm import get_reducer as j_get_reducer
from repro.configs.base import TrainConfig as JCfg
from repro.engine import get_algorithm as j_get_algorithm
from repro.engine import get_topology as j_get_topology
from repro.models import mlp as jmlp
from repro_torch.comm import NetworkModel, get_reducer
from repro_torch.comm import cost as tcost
from repro_torch.configs.base import TrainConfig
from repro_torch.engine import (Star, StreamingStar, algorithm_names,
                                get_algorithm, get_topology)
from repro_torch.engine.engine import topology_for
from repro_torch.utils import tree as T
from repro_torch.utils.convert import params_from_jax, params_to_numpy
from repro_torch.utils.rng import TorchKey


def _mlp_template(d=24, width=16, depth=3):
    return to_numpy_tree(jmlp.init_params(jax.random.key(7), d, width=width,
                                          depth=depth))


def _stacked(template, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (a[None] + 0.05 * rng.randn(n, *a.shape)).astype(
            np.float32), template)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_tree_leaf_order_and_paths_match_jax():
    tpl = _mlp_template()
    jpaths, _ = jax.tree_util.tree_flatten_with_path(tpl)
    ours, treedef = T.tree_flatten_with_path(params_from_jax(tpl))
    assert [p for p, _ in ours] == [jax.tree_util.keystr(p)
                                    for p, _ in jpaths]
    assert ours[0][0] == "['layers'][0]['b']"
    assert ours[-1][0] == "['out']['w']"
    for (_, a), (_, b) in zip(ours, jpaths):
        np.testing.assert_array_equal(a.numpy(), b)
    rebuilt = treedef.unflatten([x for _, x in ours])
    assert T.tree_structure(rebuilt) == treedef


def test_tree_helpers_and_convert_roundtrip():
    tpl = _mlp_template()
    t = params_from_jax(tpl)
    back = params_to_numpy(t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tpl)):
        np.testing.assert_array_equal(a, b)
    st = T.tree_broadcast_leading(t, 3)
    leaf = T.tree_leaves(st)[0]
    assert leaf.shape[0] == 3 and leaf.is_contiguous()
    leaf[0].add_(1.0)          # replicas are copies, not views of one
    assert not torch.equal(leaf[0], leaf[1])
    assert T.tree_leaves(None) == []
    assert T.tree_flatten_with_path({"theta": torch.zeros(3)})[0][0][0] \
        == "['theta']"
    with pytest.raises(ValueError):
        T.tree_structure({"a": 1}).flatten_up_to({"b": 1})


# ---------------------------------------------------------------------------
# reducers: same inputs, same bits
# ---------------------------------------------------------------------------

def _reduce_both(spec, stacked_np, rounds=2, **kw):
    jred = j_get_reducer(spec, **kw)
    tred = get_reducer(spec, **kw)
    js = jax.tree.map(jnp.asarray, stacked_np)
    ts = params_from_jax(stacked_np)
    jstate, tstate = jred.init_state(js), tred.init_state(ts)
    out = []
    for r in range(rounds):
        key = jax.random.key(100 + r)
        jc, jstate = jred.reduce(js, jstate, key)
        tc, tstate = tred.reduce(ts, tstate, JaxKey(key))
        out.append((jc, tc, jstate, tstate))
        # next round: drift the replicas the same way on both sides
        stacked_np = jax.tree.map(lambda a: a * np.float32(0.9), stacked_np)
        js = jax.tree.map(jnp.asarray, stacked_np)
        ts = params_from_jax(stacked_np)
    return out


def _close_tree(t_tree, j_tree, atol):
    tl, jl = T.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("spec,kw", [("dense", {}), ("int8", {}),
                                     ("int4", {}), ("topk", {"topk_frac": 0.2})])
def test_reducer_consensus_and_ef_state_match_jax(spec, kw):
    stacked = _stacked(_mlp_template())
    for jc, tc, jst, tst in _reduce_both(spec, stacked, **kw):
        _close_tree(tc, jc, 1e-6)
        if spec != "dense":
            _close_tree(tst["ref"], jst["ref"], 1e-6)
            _close_tree(tst["res"], jst["res"], 1e-6)


def test_quantized_reducer_variants_match_jax():
    from repro.comm import QuantizedMean as JQM
    from repro_torch.comm import QuantizedMean as TQM

    stacked = _stacked(_mlp_template(), seed=3)
    for kw in ({"error_feedback": False}, {"stochastic": False}):
        jred, tred = JQM(**kw), TQM(**kw)
        js = jax.tree.map(jnp.asarray, stacked)
        ts = params_from_jax(stacked)
        key = jax.random.key(5)
        jc, jst = jred.reduce(js, jred.init_state(js), key)
        tc, tst = tred.reduce(ts, tred.init_state(ts), JaxKey(key))
        _close_tree(tc, jc, 1e-6)
        _close_tree(tst["res"], jst["res"], 1e-6)
        assert tred.name == jred.name


@pytest.mark.parametrize("spec", ["dense", "int8", "topk"])
def test_streaming_star_equals_star_exactly(spec):
    ts = params_from_jax(_stacked(_mlp_template(), seed=1))
    star = get_topology("star", reducer=spec)
    stream = get_topology("streaming", reducer=spec)
    assert isinstance(stream, StreamingStar) and type(star) is Star
    for key in (TorchKey(3), JaxKey(jax.random.key(3))):
        a, sa = star.reduce(ts, star.init_state(ts), key)
        b, sb = stream.reduce(ts, stream.init_state(ts), key)
        for x, y in zip(T.tree_leaves(a), T.tree_leaves(b)):
            assert torch.equal(x, y)
        for x, y in zip(T.tree_leaves(sa), T.tree_leaves(sb)):
            assert torch.equal(x, y)


def test_torch_key_draws_depend_only_on_the_key():
    k = TorchKey(11)
    a, b = k.split(2)
    assert torch.equal(a.fold_in(3).bits((4, 5)), a.fold_in(3).bits((4, 5)))
    assert not torch.equal(a.bits((4, 5)), b.bits((4, 5)))
    idx = a.batch_indices(4, 8, 10)
    assert idx.shape == (4, 8) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 10
    assert k.bits((3,)).dtype == torch.int32


def test_get_reducer_and_topology_specs():
    assert get_reducer("int4").bits == 4
    assert get_reducer("quant", quant_bits=6).name == "int6"
    assert get_reducer("topk", topk_frac=0.3).frac == 0.3
    with pytest.raises(ValueError):
        get_reducer("bogus")
    with pytest.raises(NotImplementedError, match="later slice"):
        get_topology("hier")
    with pytest.raises(NotImplementedError):
        topology_for(TrainConfig(topology="hier"))
    with pytest.raises(NotImplementedError):
        get_reducer("staleness")


# ---------------------------------------------------------------------------
# registry, stages and cost ledger
# ---------------------------------------------------------------------------

def test_registry_stage_lists_match_jax():
    names = algorithm_names()
    assert len(names) == 8 and "adaptive" in names
    for iid in (True, False):
        cfg = dict(eta1=0.3, T1=40, k1=3.0, n_stages=5, iid=iid)
        for name in names + ("stl_sc+async",):
            ours = get_algorithm(name).stages(TrainConfig(**cfg))
            ref = j_get_algorithm(name).stages(JCfg(**cfg))
            assert [(s.s, s.eta, s.T, s.k, s.k_raw) for s in ours] == \
                [(s.s, s.eta, s.T, s.k, s.k_raw) for s in ref]
    assert get_algorithm("stl_sc+async").sync_policy.asynchronous


@pytest.mark.parametrize("spec", ["dense", "int8", "int4", "topk"])
@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("downlink", [False, True])
def test_hop_and_leaf_costs_match_jax(spec, model, downlink):
    tpl = ({"theta": np.zeros((784,), np.float32)} if model == "logreg"
           else _mlp_template(d=784, width=96))
    net_kw = dict(latency_s=2e-3, bandwidth_gbps=0.5, count_downlink=downlink)
    from repro.comm import NetworkModel as JNet

    jt = j_get_topology("star", reducer=spec, network=JNet(**net_kw))
    tt = get_topology("streaming", reducer=spec, network=NetworkModel(**net_kw))
    ttpl = params_from_jax(tpl)
    jh, th = jt.hop_costs(tpl, 32), tt.hop_costs(ttpl, 32)
    assert [(h.hop, h.reducer, h.bytes, h.time_s) for h in th] == \
        [(h.hop, h.reducer, h.bytes, h.time_s) for h in jh]
    jl, tl = jt.leaf_costs(tpl, 32), tt.leaf_costs(ttpl, 32)
    assert [(c.leaf, c.path, c.hop, c.bytes, c.time_s) for c in tl] == \
        [(c.leaf, c.path, c.hop, c.bytes, c.time_s) for c in jl]
    if model == "logreg" and spec == "int8":
        assert th[0].bytes == 32 * (784 + 4)


def test_comm_summary_matches_jax():
    from repro.comm import comm_summary_for as j_summary

    cfg = dict(reducer="int8", comm_latency_s=1e-3, comm_bandwidth_gbps=2.0)
    tpl = {"theta": np.zeros((784,), np.float32)}
    ours = tcost.comm_summary_for(TrainConfig(**cfg), params_from_jax(tpl),
                                  32, 96)
    assert ours == j_summary(JCfg(**cfg), tpl, 32, 96)
    assert tcost.dense_bytes(params_from_jax(tpl)) == 784 * 4
