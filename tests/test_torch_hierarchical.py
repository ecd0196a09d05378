"""The port's two-level ``Hierarchical`` topology against the JAX package's.

The same numpy stacked replicas and the same draws (a ``JaxKey`` that
replays ``fold_in(rng, pod)`` / ``fold_in(rng, n_pods)``, then the
per-leaf ``fold_in`` and ``jax.random.bits``) go through both packages.
Tolerances:

  * one reduce: consensus and every level's error-feedback state within
    1e-6 absolute (the client mean sums in another order). The int8 codes
    are then exact: a flipped code would move a residual by scale/qmax,
    orders of magnitude above 1e-6;
  * within the port, dense∘dense equals ``Star`` and the streaming round
    equals the blocking one, bit for bit;
  * the cost model (hop and leaf costs, summaries): equal;
  * ``simulate.run`` histories: 1e-5 dense, 1e-4 int8 (as the simulator's
    parity tests state them);
  * ``runtime.run``: cohort, modeled wall clock, event trace and ledger
    equal (pure arithmetic on the same floats); histories and final
    parameters as ``simulate.run``'s;
  * ``DeviceModel`` step prices: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, to_numpy_tree
from repro import runtime as JR
from repro.comm import NetworkModel as JNet
from repro.comm import comm_summary_for as j_summary
from repro.comm import link_model as j_link
from repro.configs import get_arch as j_get_arch
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import TrainConfig as JCfg
from repro.core import simulate as JS
from repro.engine import get_topology as j_get_topology
from repro.models import logreg as jlogreg
from repro.models import mlp as jmlp
from repro.serve import DeviceModel as JDeviceModel
from repro_torch import runtime as TR
from repro_torch.comm import NetworkModel, link_model
from repro_torch.comm import cost as tcost
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core import simulate as TS
from repro_torch.data import make_binary_classification, partition_iid
from repro_torch.engine import (Hierarchical, Star, StreamingStar,
                                get_topology, topology_for)
from repro_torch.models import logreg, mlp
from repro_torch.serve import DeviceModel
from repro_torch.utils import tree as T
from repro_torch.utils.convert import params_from_jax, params_to_numpy
from repro_torch.utils.rng import TorchKey

_LAM = 1e-3
_MODELS = {"logreg": (jlogreg, logreg), "mlp": (jmlp, mlp)}
_HIER_SPECS = ("hier", "hierarchical", "pods")
_STREAM_SPECS = ("streaming-hier", "hier-streaming", "streaming-hierarchical")


def _mlp_template(d=24, width=16, depth=3):
    return to_numpy_tree(jmlp.init_params(jax.random.key(7), d, width=width,
                                          depth=depth))


def _stacked(template, n=8, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (a[None] + 0.05 * rng.randn(n, *a.shape)).astype(
            np.float32), template)


def _close_tree(t_tree, j_tree, atol):
    tl, jl = T.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)


def _equal_tree(a, b):
    la, lb = T.tree_leaves(a), T.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _topologies(intra, inter, streaming, n_pods=2, **kw):
    spec = "streaming-hier" if streaming else "hier"
    return (j_get_topology(spec, reducer=intra, inter_reducer=inter,
                           n_pods=n_pods, **kw),
            get_topology(spec, reducer=intra, inter_reducer=inter,
                         n_pods=n_pods, **kw))


# ---------------------------------------------------------------------------
# one reduce: same inputs, same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("inter", ["dense", "int8"])
@pytest.mark.parametrize("intra", ["dense", "int8", "topk"])
def test_hierarchical_reduce_matches_jax(intra, inter, streaming):
    jt, tt = _topologies(intra, inter, streaming, topk_frac=0.2)
    assert type(tt) is Hierarchical and tt.name == jt.name
    assert (tt.n_pods, tt.intra.name, tt.inter.name) == \
        (jt.n_pods, jt.intra.name, jt.inter.name)
    stacked = _stacked(_mlp_template())
    js = jax.tree.map(jnp.asarray, stacked)
    ts = params_from_jax(stacked)
    jst, tst = jt.init_state(js), tt.init_state(ts)
    for r in range(2):
        key = jax.random.key(100 + r)
        jc, jst = jt.reduce(js, jst, key)
        tc, tst = tt.reduce(ts, tst, JaxKey(key))
        _close_tree(tc, jc, 1e-6)
        _close_tree(tst, jst, 1e-6)
        # the next round's replicas drift the same way on both sides
        stacked = jax.tree.map(lambda a: a * np.float32(0.9), stacked)
        js = jax.tree.map(jnp.asarray, stacked)
        ts = params_from_jax(stacked)


@pytest.mark.parametrize("inter", ["dense", "int8"])
@pytest.mark.parametrize("intra", ["dense", "int8", "topk"])
def test_streaming_hier_equals_blocking_exactly(intra, inter):
    ts = params_from_jax(_stacked(_mlp_template(), seed=1))
    blk = get_topology("hier", reducer=intra, inter_reducer=inter)
    stm = get_topology("streaming-hier", reducer=intra, inter_reducer=inter)
    assert not blk.streaming and stm.streaming
    for key in (TorchKey(3), JaxKey(jax.random.key(3))):
        sa, sb = blk.init_state(ts), stm.init_state(ts)
        for _ in range(2):
            a, sa = blk.reduce(ts, sa, key)
            b, sb = stm.reduce(ts, sb, key)
            assert _equal_tree(a, b) and _equal_tree(sa, sb)


@pytest.mark.parametrize("streaming", [False, True])
def test_dense_dense_hierarchical_equals_star_exactly(streaming):
    ts = params_from_jax(_stacked(_mlp_template(), seed=2))
    hier = get_topology("streaming-hier" if streaming else "hier",
                        reducer="dense", inter_reducer="dense")
    assert hier.all_dense
    star = get_topology("star", reducer="dense")
    a, _ = hier.reduce(ts, hier.init_state(ts), TorchKey(0))
    b, _ = star.reduce(ts, star.init_state(ts), TorchKey(0))
    assert _equal_tree(a, b)


def test_intra_state_holds_no_view_of_the_replicas():
    """The round writes the consensus back into the replicas in place
    (``simulate._sync_``); the state the reduce returned must not move."""
    ts = params_from_jax(_stacked(_mlp_template(), seed=4))
    topo = get_topology("hier", reducer="int8", inter_reducer="int8")
    _, st = topo.reduce(ts, topo.init_state(ts), TorchKey(1))
    before = [t.clone() for t in T.tree_leaves(st)]
    for x in T.tree_leaves(ts):
        x.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, T.tree_leaves(st)))


# ---------------------------------------------------------------------------
# specs, shapes and the cost model
# ---------------------------------------------------------------------------

def test_hierarchical_specs_resolve_as_jax():
    for spec in _HIER_SPECS + _STREAM_SPECS:
        ours = get_topology(spec, reducer="topk", inter_reducer="int4")
        ref = j_get_topology(spec, reducer="topk", inter_reducer="int4")
        assert (ours.name, ours.streaming, ours.intra.name, ours.inter.name,
                ours.intra_net, ours.inter_net) == \
            (ref.name, ref.streaming, ref.intra.name, ref.inter.name,
             NetworkModel(**dataclasses.asdict(ref.intra_net)),
             NetworkModel(**dataclasses.asdict(ref.inter_net)))
    # the default inter-pod reducer is int8, the links ICI and WAN
    t = get_topology("hier")
    assert (t.inter.name, t.intra_net, t.inter_net) == \
        ("int8", link_model("ici"), link_model("wan"))
    net = NetworkModel(latency_s=2e-3, bandwidth_gbps=3.0)
    assert get_topology("pods", network=net).inter_net == net
    # one pod is the flat round
    for spec in _HIER_SPECS:
        assert type(get_topology(spec, n_pods=1, reducer="int8")) is Star
    for spec in _STREAM_SPECS:
        assert type(get_topology(spec, n_pods=1)) is StreamingStar
    # TrainConfig's fields reach the topology
    topo = topology_for(TrainConfig(topology="hier", n_pods=4,
                                    reducer="topk", inter_reducer="int4"))
    assert (topo.n_pods, topo.intra.name, topo.inter.name) == \
        (4, "top0.1", "int4")


def test_indivisible_pods_raise():
    topo = get_topology("hier", n_pods=3)
    tpl = params_from_jax(_mlp_template())
    with pytest.raises(ValueError, match="not divisible"):
        topo.init_state(params_from_jax(_stacked(_mlp_template(), n=8)))
    for fn in (topo.hop_costs, topo.leaf_costs):
        with pytest.raises(ValueError, match="not divisible"):
            fn(tpl, 8)


@pytest.mark.parametrize("downlink", [False, True])
@pytest.mark.parametrize("inter", ["dense", "int8", "topk"])
@pytest.mark.parametrize("intra", ["dense", "int8", "int4"])
def test_hierarchical_costs_match_jax(intra, inter, downlink):
    tpl = _mlp_template(d=784, width=96)
    kw = dict(latency_s=2e-3, bandwidth_gbps=0.5, count_downlink=downlink)
    jt = j_get_topology("hier", reducer=intra, inter_reducer=inter,
                        n_pods=4, network=JNet(**kw))
    tt = get_topology("hier", reducer=intra, inter_reducer=inter, n_pods=4,
                      network=NetworkModel(**kw))
    ttpl = params_from_jax(tpl)
    jh, th = jt.hop_costs(tpl, 32), tt.hop_costs(ttpl, 32)
    assert [(h.hop, h.reducer, h.bytes, h.time_s) for h in th] == \
        [(h.hop, h.reducer, h.bytes, h.time_s) for h in jh]
    assert [h.hop for h in th] == (["intra_pod", "inter_pod"]
                                   + ["downlink"] * downlink)
    jl, tl = jt.leaf_costs(tpl, 32), tt.leaf_costs(ttpl, 32)
    assert [(c.leaf, c.path, c.hop, c.bytes, c.time_s) for c in tl] == \
        [(c.leaf, c.path, c.hop, c.bytes, c.time_s) for c in jl]
    # the per-leaf ledger reconciles with the hops, bytes exactly
    for h in th:
        assert sum(c.bytes for c in tl if c.hop == h.hop) == h.bytes
    assert tt.summary(ttpl, 32, 7) == jt.summary(tpl, 32, 7)


@pytest.mark.parametrize("topology", ["hier", "streaming-hier", "star"])
def test_comm_summary_for_matches_jax(topology):
    cfg = dict(reducer="dense", inter_reducer="int8", topology=topology,
               n_pods=4, comm_latency_s=1e-3, comm_bandwidth_gbps=2.0)
    tpl = {"theta": np.zeros((123,), np.float32)}
    ours = tcost.comm_summary_for(TrainConfig(**cfg), params_from_jax(tpl),
                                  32, 96)
    assert ours == j_summary(JCfg(**cfg), tpl, 32, 96)
    if topology != "star":
        assert ours["reducer"] == "dense+int8"


# ---------------------------------------------------------------------------
# simulate.run and runtime.run over the two-level round
# ---------------------------------------------------------------------------

def _problem(model, d, N, n=256):
    x, y = make_binary_classification(n=n, d=d, seed=0)
    data = partition_iid(x, y, N, seed=1)
    jp0 = (jlogreg.init_params(None, d) if model == "logreg" else
           jmlp.init_params(jax.random.key(42), d, width=16, depth=3))
    return x, y, data, jp0


_STL = dict(algo="stl_sc", eta1=0.5, T1=16, k1=4.0, n_stages=2,
            batch_per_client=8, seed=0)


@pytest.mark.parametrize("model,intra,inter,tol", [
    ("logreg", "dense", "dense", 1e-5),
    ("logreg", "dense", "int8", 1e-4),
    ("mlp", "int8", "int8", 1e-4),
    ("mlp", "topk", "dense", 1e-5)])
@pytest.mark.parametrize("topology", ["hier", "streaming-hier"])
def test_simulate_hierarchical_matches_jax(model, intra, inter, tol,
                                           topology):
    jm, tm = _MODELS[model]
    x, y, data, jp0 = _problem(model, 32, 8)
    cfg = dict(_STL, reducer=intra, inter_reducer=inter, topology=topology,
               n_pods=2)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jhist = JS.run(lambda p, b: jm.loss_fn(p, b, _LAM), jp0,
                   {k: jnp.asarray(v) for k, v in data.items()}, JCfg(**cfg),
                   jax.jit(lambda p: jm.full_objective(p, xj, yj, _LAM)),
                   chunk_rounds=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    thist = TS.run(lambda p, b: tm.loss_fn(p, b, _LAM),
                   params_from_jax(to_numpy_tree(jp0)),
                   {k: torch.from_numpy(v) for k, v in data.items()},
                   TrainConfig(**cfg),
                   lambda p: tm.full_objective(p, xt, yt, _LAM), device="cpu",
                   chunk_rounds=4, rng=JaxKey(jax.random.key(0)))
    assert [(r.round, r.iteration) for r in thist] == \
        [(r.round, r.iteration) for r in jhist]
    np.testing.assert_allclose([r.value for r in thist],
                               [r.value for r in jhist], atol=tol, rtol=0)
    assert thist[-1].value < thist[0].value


def _runtime_pair(cfg_kw, model="logreg", d=16, N=8, n=256, **run_kw):
    jm, tm = _MODELS[model]
    x, y, data, jp0 = _problem(model, d, N, n)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jres = JR.run(lambda p, b: jm.loss_fn(p, b, _LAM), jp0,
                  {k: jnp.asarray(v) for k, v in data.items()},
                  JCfg(**cfg_kw),
                  jax.jit(lambda p: jm.full_objective(p, xj, yj, _LAM)),
                  eval_every=2, chunk_rounds=4, **run_kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tres = TR.run(lambda p, b: tm.loss_fn(p, b, _LAM),
                  params_from_jax(to_numpy_tree(jp0)),
                  {k: torch.from_numpy(v) for k, v in data.items()},
                  TrainConfig(**cfg_kw),
                  lambda p: tm.full_objective(p, xt, yt, _LAM),
                  device="cpu", eval_every=2, chunk_rounds=4,
                  rng=JaxKey(jax.random.key(cfg_kw.get("seed", 0))),
                  **run_kw)
    return jres, tres


def _check_runtime(jres, tres, tol):
    assert [(r.round, r.iteration) for r in tres.history] == \
        [(r.round, r.iteration) for r in jres.history]
    np.testing.assert_allclose([r.value for r in tres.history],
                               [r.value for r in jres.history], atol=tol,
                               rtol=0)
    assert tres.wall_clock_s == jres.wall_clock_s
    assert tres.trace == jres.trace
    assert [(t, r) for t, r, _ in tres.timeline] == \
        [(t, r) for t, r, _ in jres.timeline]
    assert (tres.rounds, tres.iters, tres.comm_bytes) == \
        (jres.rounds, jres.iters, jres.comm_bytes)
    assert tres.comm_time_s == pytest.approx(jres.comm_time_s, rel=1e-12)
    assert tres.leaf_ledger == jres.leaf_ledger
    for a, b in zip(T.tree_leaves(params_to_numpy(tres.params)),
                    jax.tree.leaves(to_numpy_tree(jres.params))):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("schedule", ["blocking", "streaming"])
def test_runtime_hier_stragglers_dropout_match_jax(schedule):
    cfg = dict(_STL, reducer="dense", inter_reducer="int8", topology="hier",
               n_pods=2, straggler_frac=0.25, straggler_slowdown=4.0,
               dropout_rate=0.2, upload_schedule=schedule)
    jres, tres = _runtime_pair(cfg)
    _check_runtime(jres, tres, 1e-4)
    assert any(e[1] == "dropout" for e in tres.trace)
    # the serial inter-pod hop stretches every barrier past the star's
    _, star = _runtime_pair(dict(cfg, topology="star"))
    assert tres.wall_clock_s > star.wall_clock_s


@pytest.mark.parametrize("reducer", ["dense", "int8"])
def test_runtime_table5d_schedules_match_jax(reducer):
    """Table 5d at a small size: the MLP over the streaming two-level round
    with a billed downlink, under three schedules."""
    base = dict(algo="sync", eta1=0.1, T1=8, n_stages=2,
                batch_per_client=8, seed=0, reducer=reducer,
                inter_reducer=reducer, topology="streaming-hier", n_pods=2,
                count_downlink=True, comm_latency_s=1e-4,
                comm_bandwidth_gbps=0.45, base_step_time_s=1e-3,
                straggler_frac=0.25, straggler_slowdown=4.0)
    tol = 1e-5 if reducer == "dense" else 1e-4
    out = {}
    for sched in ("blocking", "streaming-uplink", "streaming"):
        jres, tres = _runtime_pair(dict(base, upload_schedule=sched),
                                   model="mlp")
        _check_runtime(jres, tres, tol)
        out[sched] = tres
        assert {l["hop"] for l in tres.leaf_ledger} == \
            {"intra_pod", "inter_pod", "downlink"}
        assert sum(l["bytes"] for l in tres.leaf_ledger) == tres.comm_bytes
    # the schedules price time only: the port's parameters are bit-equal
    blk = out["blocking"]
    for sched in ("streaming-uplink", "streaming"):
        assert _equal_tree(out[sched].params, blk.params)
    assert any(e[1] == "wan_leaf" for e in out["streaming"].trace)
    assert out["streaming"].wall_clock_s < blk.wall_clock_s


def test_runtime_refuses_a_streamed_wan_hop_without_leaf_bytes():
    from repro_torch.comm import Reducer

    class Opaque(Reducer):
        name = "opaque"

        def init_state(self, stacked):
            return None

        def reduce(self, stacked, state, rng):
            return T.tree_mean_leading(stacked), state

        def message_bytes(self, template):
            return 8

    x, y, data, _ = _problem("logreg", 8, 4, 64)
    topo = Hierarchical(n_pods=2, inter=Opaque())
    cfg = TrainConfig(**dict(_STL, upload_schedule="streaming"))
    with pytest.raises(ValueError, match="streaming-uplink"):
        TR.run(lambda p, b: logreg.loss_fn(p, b, _LAM), logreg.init_params(8),
               {k: torch.from_numpy(v) for k, v in data.items()}, cfg,
               lambda p: torch.zeros(()), device="cpu", topology=topo)


# ---------------------------------------------------------------------------
# the multi-chip DeviceModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-2.7b"])
@pytest.mark.parametrize("n_chips", [1, 4])
def test_device_model_multi_chip_prices_as_jax(arch, n_chips):
    kw = dict(peak_flops=989e12, hbm_bw=3.35e12, n_chips=n_chips)
    for link in (None, (2e-6, 400.0)):
        jl = None if link is None else JNet(*link)
        tl = None if link is None else NetworkModel(*link)
        jd, td = JDeviceModel(link=jl, **kw), DeviceModel(link=tl, **kw)
        for shape in ("decode_32k", "prefill_32k"):
            assert td.step_time_s(get_arch(arch), SHAPES[shape]) == \
                jd.step_time_s(j_get_arch(arch), J_SHAPES[shape])
    # the default link is the reference's ICI preset
    assert DeviceModel(n_chips=4)._link() == \
        NetworkModel(**dataclasses.asdict(j_link("ici")))
