"""The port's event runtime against the JAX package's.

Both packages get the same numpy data and weights, and the port draws
through a ``JaxKey`` that replays the JAX key schedule (chunk, round,
step and client splits; the reducer's ``fold_in``; the asynchronous
job's one-client draw straight from the step key). The JAX side runs as
``tests/test_runtime.py`` runs it: on the CPU, with the reducers'
default ``impl="xla"``. Tolerances:

  * the cohort (``sample_clients``): equal, field for field — numpy with
    the same ``RandomState`` salt and draw order on both sides;
  * schedule events, ``wall_clock_s``, the event ``trace`` (which holds
    every dropout and drop event, so the dropout masks too) and the comm
    ledger: equal — pure Python arithmetic on the same floats;
  * histories: 1e-5 absolute (dense) and 1e-4 (int8), as the simulator's
    parity tests state them (summation order; a code may flip at a
    floor() boundary); the (round, iteration) pairs are equal;
  * the asynchronous runs' final server parameters: 1e-5 (dense) and
    1e-4 (staleness-int8), absolute;
  * ``StalenessWeightedMean.encode`` / ``merge`` per message: the
    payload, the residual and the merged server within 1e-7 absolute
    (the same float32 ops in the same order; int codes equal);
  * ``gradient_diversity``: 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, to_numpy_tree
from repro import runtime as JR
from repro.comm import cost as jcost
from repro.comm import reducer as jred
from repro.configs.base import TrainConfig as JCfg
from repro.data import partition as jpart
from repro.models import logreg as jlogreg
from repro.models import mlp as jmlp
from repro_torch import runtime as TR
from repro_torch.comm import StalenessWeightedMean, get_reducer, link_model
from repro_torch.comm import NetworkModel
from repro_torch.configs.base import TrainConfig
from repro_torch.core import simulate as TS
from repro_torch.data import make_binary_classification, partition_iid
from repro_torch.data.partition import gradient_diversity
from repro_torch.engine import Engine, Star, get_algorithm, make_async
from repro_torch.models import logreg, mlp
from repro_torch.runtime import Heterogeneity, sample_clients
from repro_torch.utils.convert import params_from_jax, params_to_numpy
from repro_torch.utils.tree import tree_leaves

_LAM = 1e-2
_MODELS = {"logreg": (jlogreg, logreg), "mlp": (jmlp, mlp)}


def _problem(model, d, N, n):
    x, y = make_binary_classification(n=n, d=d, seed=3)
    data = partition_iid(x, y, N, seed=0)
    if model == "logreg":
        jp0 = jlogreg.init_params(None, d)
    else:
        jp0 = jmlp.init_params(jax.random.key(42), d, width=16, depth=3)
    return x, y, data, jp0


def _run_pair(cfg_kw, *, model="logreg", d=16, N=4, n=256, eval_every=2,
              **run_kw):
    """The same configuration through both packages' ``runtime.run``."""
    jm, tm = _MODELS[model]
    x, y, data, jp0 = _problem(model, d, N, n)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jres = JR.run(lambda p, b: jm.loss_fn(p, b, _LAM), jp0,
                  {k: jnp.asarray(v) for k, v in data.items()},
                  JCfg(**cfg_kw),
                  jax.jit(lambda p: jm.full_objective(p, xj, yj, _LAM)),
                  eval_every=eval_every, chunk_rounds=4, **run_kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tres = TR.run(lambda p, b: tm.loss_fn(p, b, _LAM),
                  params_from_jax(to_numpy_tree(jp0)),
                  {k: torch.from_numpy(v) for k, v in data.items()},
                  TrainConfig(**cfg_kw),
                  lambda p: tm.full_objective(p, xt, yt, _LAM),
                  device="cpu", eval_every=eval_every, chunk_rounds=4,
                  rng=JaxKey(jax.random.key(cfg_kw.get("seed", 0))),
                  **run_kw)
    return jres, tres


def _check(jres, tres, tol):
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
    for a, b in zip(tree_leaves(params_to_numpy(tres.params)),
                    jax.tree.leaves(to_numpy_tree(jres.params))):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _cfg(**kw):
    base = dict(algo="stl_sc", eta1=0.5, T1=16, k1=2.0, n_stages=3,
                batch_per_client=8, seed=0)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# cohort, link presets and schedules: equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ici", "dcn", "wan"])
def test_link_model_presets_equal_jax(name):
    ours, ref = link_model(name), jcost.link_model(name)
    assert (ours.latency_s, ours.bandwidth_gbps, ours.count_downlink) == \
        (ref.latency_s, ref.bandwidth_gbps, ref.count_downlink)
    with pytest.raises(ValueError, match="unknown link preset"):
        link_model("nvlink")


@pytest.mark.parametrize("n,profile", [
    (8, dict(straggler_frac=0.25, straggler_slowdown=4.0)),
    (8, dict(straggler_frac=0.25, straggler_slowdown=2.0, jitter=0.1,
             seed=7)),
    (5, dict(jitter=0.3, dropout=0.1, link="dcn", seed=3)),
    (4, dict()),
])
def test_sample_clients_equal_jax(n, profile):
    net = NetworkModel(latency_s=1e-4, bandwidth_gbps=0.45)
    ours = sample_clients(n, Heterogeneity(**profile), net)
    ref = JR.sample_clients(n, JR.Heterogeneity(**profile),
                            jcost.NetworkModel(latency_s=1e-4,
                                               bandwidth_gbps=0.45))
    fields = lambda c: (c.cid, c.rate, c.step_time_s, c.straggler,
                        c.network.latency_s, c.network.bandwidth_gbps,
                        c.network.count_downlink)
    assert [fields(c) for c in ours] == [fields(c) for c in ref]
    assert Heterogeneity(**profile).enabled == \
        JR.Heterogeneity(**profile).enabled


@pytest.mark.parametrize("spec", ["blocking", "streaming",
                                  "streaming-uplink"])
def test_schedule_events_equal_jax(spec):
    het = dict(straggler_frac=0.25, straggler_slowdown=3.0, jitter=0.2,
               seed=1)
    ours_c = sample_clients(4, Heterogeneity(**het),
                            NetworkModel(latency_s=1e-4, bandwidth_gbps=0.45,
                                         count_downlink=True))
    ref_c = JR.sample_clients(4, JR.Heterogeneity(**het),
                              jcost.NetworkModel(latency_s=1e-4,
                                                 bandwidth_gbps=0.45,
                                                 count_downlink=True))
    ours, ref = TR.get_schedule(spec), JR.get_schedule(spec)
    assert (ours.name, ours.streams_uplink, ours.streams_round) == \
        (ref.name, ref.streams_uplink, ref.streams_round)
    leaf_bytes, fracs = [40, 1540, 17, 9220, 5], [0.1, 0.3, 0.05, 0.5, 0.05]
    for a, b in zip(ours_c, ref_c):
        for active in (True, False):
            assert ours.round_events(a, 0.25, 3, leaf_bytes, fracs,
                                     active=active) == \
                ref.round_events(b, 0.25, 3, leaf_bytes, fracs,
                                 active=active)
        done = [0.5, 0.52, 0.49, 0.61, 0.6]
        assert ours.broadcast_events(a, done, leaf_bytes) == \
            ref.broadcast_events(b, done, leaf_bytes)
    with pytest.raises(ValueError):
        TR.get_schedule("bogus")


# ---------------------------------------------------------------------------
# StalenessWeightedMean, one message at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["staleness", "staleness-int8",
                                  "staleness-int4"])
def test_staleness_encode_and_merge_match_jax(spec):
    ours = get_reducer(spec, staleness_decay=0.7)
    ref = jred.get_reducer(spec, staleness_decay=0.7)
    assert ours.name == ref.name
    tpl = to_numpy_tree(jmlp.init_params(jax.random.key(5), 12, width=8,
                                         depth=2))
    rng = np.random.RandomState(2)
    server_np = jax.tree.map(lambda a: a + 0.1, tpl)
    server_j = jax.tree.map(jnp.asarray, server_np)
    server_t = params_from_jax(server_np)
    res_j = ref.client_residual(server_j)
    res_t = ours.client_residual(server_t)
    assert ours.message_bytes(server_t) == ref.message_bytes(server_j)
    assert ours.leaf_message_bytes(server_t) == \
        ref.leaf_message_bytes(server_j)
    for msg in range(3):
        delta = jax.tree.map(
            lambda a: (0.01 * rng.randn(*a.shape)).astype(np.float32), tpl)
        key = jax.random.fold_in(jax.random.key(9), msg)
        pay_j, res_j = ref.encode(jax.tree.map(jnp.asarray, delta), res_j,
                                  key)
        pay_t, res_t = ours.encode(params_from_jax(delta), res_t,
                                   JaxKey(key))
        for a, b in zip(tree_leaves(pay_t) + tree_leaves(res_t),
                        jax.tree.leaves(pay_j) + jax.tree.leaves(res_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                       rtol=0)
        server_j = ref.merge(server_j, pay_j, staleness=0.5 * msg,
                             n_clients=4)
        server_t = ours.merge(server_t, pay_t, staleness=0.5 * msg,
                              n_clients=4)
        for a, b in zip(tree_leaves(server_t), jax.tree.leaves(server_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                       rtol=0)
    assert ours.weight(3) == ref.weight(3)
    assert ours.weight(-1) == 1.0


def test_staleness_reducer_for_maps_specs_like_jax():
    for kw in (dict(), dict(reducer="int8"), dict(reducer="quant",
                                                  quant_bits=4),
               dict(reducer="int2"), dict(reducer="staleness-int8")):
        ours = TR.staleness_reducer_for(TrainConfig(**kw))
        ref = JR.staleness_reducer_for(JCfg(**kw))
        assert (ours.name, ours.bits, ours.decay) == \
            (ref.name, ref.bits, ref.decay)
    with pytest.raises(ValueError):
        TR.staleness_reducer_for(TrainConfig(reducer="topk",
                                             async_mode=True))


# ---------------------------------------------------------------------------
# whole runs: synchronous (barrier rounds replayed on the clock)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,tol", [
    (dict(), 1e-5),
    (dict(straggler_frac=0.25, straggler_slowdown=4.0, dropout_rate=0.25),
     1e-5),
    (dict(reducer="int8", momentum=0.5, dropout_rate=0.25,
          compute_jitter=0.2), 1e-4),
    (dict(algo="local", k1=4.0, T1=24, n_stages=2, reducer="int8",
          straggler_frac=0.25, straggler_slowdown=2.0), 1e-4),
])
def test_sync_runtime_matches_jax(kw, tol):
    jres, tres = _run_pair(_cfg(**kw))
    _check(jres, tres, tol)
    if kw.get("dropout_rate"):
        # the masks bit: some clients dropped, and each dropped client
        # still answers the barrier with a zero-delta message
        kinds = [e[1] for e in tres.trace]
        assert kinds.count("dropout") > 0
        assert kinds.count("arrival") == 4 * kinds.count("merge")


@pytest.mark.parametrize("kw,tol", [
    (dict(upload_schedule="streaming"), 1e-5),
    (dict(upload_schedule="streaming", count_downlink=True,
          straggler_frac=0.25, straggler_slowdown=2.0, reducer="int8"),
     1e-4),
    (dict(upload_schedule="streaming-uplink", count_downlink=True,
          dropout_rate=0.2), 1e-5),
])
def test_sync_streaming_mlp_matches_jax(kw, tol):
    cfg = dict(algo="sync", eta1=0.1, T1=6, n_stages=2, batch_per_client=8,
               seed=0, comm_latency_s=1e-4, comm_bandwidth_gbps=0.45,
               base_step_time_s=1e-3, **kw)
    jres, tres = _run_pair(cfg, model="mlp", d=12, N=4, n=128)
    _check(jres, tres, tol)
    assert any(e[1] == "leaf_arrival" for e in tres.trace)


def test_streaming_changes_the_clock_not_the_history():
    """In the port alone: streaming and blocking runs of one config give
    the same history and parameters exactly; only the clock differs."""
    x, y, data, jp0 = _problem("mlp", 12, 4, 128)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = {}
    for sched in ("blocking", "streaming"):
        cfg = TrainConfig(algo="sync", eta1=0.1, T1=6, n_stages=2,
                          batch_per_client=8, seed=0, comm_latency_s=1e-4,
                          comm_bandwidth_gbps=0.45, upload_schedule=sched)
        out[sched] = TR.run(lambda p, b: mlp.loss_fn(p, b, _LAM),
                            params_from_jax(to_numpy_tree(jp0)),
                            {k: torch.from_numpy(v) for k, v in data.items()},
                            cfg, lambda p: mlp.full_objective(p, xt, yt, _LAM),
                            device="cpu")
    blk, stm = out["blocking"], out["streaming"]
    assert [(h.round, h.value) for h in blk.history] == \
        [(h.round, h.value) for h in stm.history]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(blk.params),
                                                 tree_leaves(stm.params)))
    assert stm.wall_clock_s < blk.wall_clock_s


def test_history_without_heterogeneity_equals_simulate():
    x, y, data, jp0 = _problem("logreg", 16, 4, 256)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    args = (lambda p, b: logreg.loss_fn(p, b, _LAM), logreg.init_params(16),
            {k: torch.from_numpy(v) for k, v in data.items()},
            TrainConfig(**_cfg(reducer="int8")),
            lambda p: logreg.full_objective(p, xt, yt, _LAM))
    sim = TS.run(*args, device="cpu", eval_every=2)
    res = TR.run(*args, device="cpu", eval_every=2)
    assert [(h.round, h.iteration, h.value) for h in sim] == \
        [(h.round, h.iteration, h.value) for h in res.history]
    assert res.wall_clock_s > 0.0


def test_stragglers_stretch_the_clock_not_the_history():
    x, y, data, jp0 = _problem("logreg", 16, 4, 256)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    runs = [TR.run(lambda p, b: logreg.loss_fn(p, b, _LAM),
                   logreg.init_params(16),
                   {k: torch.from_numpy(v) for k, v in data.items()},
                   TrainConfig(**_cfg(**kw)),
                   lambda p: logreg.full_objective(p, xt, yt, _LAM),
                   device="cpu")
            for kw in (dict(), dict(straggler_frac=0.25,
                                    straggler_slowdown=4.0))]
    assert [(h.round, h.value) for h in runs[0].history] == \
        [(h.round, h.value) for h in runs[1].history]
    assert runs[1].wall_clock_s > 2.0 * runs[0].wall_clock_s


# ---------------------------------------------------------------------------
# whole runs: asynchronous (merge on arrival)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,tol", [
    (dict(), 1e-5),
    (dict(reducer="int8"), 1e-4),
    (dict(reducer="int8", momentum=0.5, dropout_rate=0.25,
          straggler_frac=0.25, straggler_slowdown=2.0), 1e-4),
    (dict(algo="local", k1=4.0, T1=24, n_stages=2, momentum=0.5,
          straggler_frac=0.25, straggler_slowdown=3.0, compute_jitter=0.1,
          staleness_decay=1.0), 1e-5),
])
def test_async_runtime_matches_jax(kw, tol):
    jres, tres = _run_pair(_cfg(async_mode=True, **kw))
    _check(jres, tres, tol)
    if kw.get("dropout_rate"):
        assert any(e[1] == "drop" for e in tres.trace)


def test_async_mlp_staleness_int8_matches_jax():
    """A multi-leaf tree: one one-row quantize and dequant_mean per leaf
    per upload, on the plain versions here."""
    jres, tres = _run_pair(_cfg(algo="stl_sc+async", reducer="int8", T1=8,
                                n_stages=2, straggler_frac=0.25,
                                straggler_slowdown=2.0),
                           model="mlp", d=12, N=4, n=128)
    _check(jres, tres, 1e-4)


class _WatchedMerge(StalenessWeightedMean):
    """Records, at every merge, whether the server model moved since the
    previous merge and how large the merged payload is."""

    def __init__(self, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "log", [])
        object.__setattr__(self, "last", None)

    def merge(self, server, payload, staleness, n_clients):
        if self.last is not None:
            moved = any(not torch.equal(a, b) for a, b in
                        zip(tree_leaves(server), tree_leaves(self.last)))
        else:
            moved = False
        norm = sum(float(torch.sum(p * p)) for p in tree_leaves(payload))
        self.log.append((moved, norm))
        out = super().merge(server, payload, staleness, n_clients)
        object.__setattr__(self, "last",
                           [t.clone() for t in tree_leaves(out)])
        return out


@pytest.mark.parametrize("kw", [dict(), dict(dropout_rate=0.3,
                                             momentum=0.5)])
def test_async_clients_step_their_own_copy(kw):
    """The fused update writes a client's parameters in place, so a pull
    that aliased the server model (or a delta reference that aliased the
    stepped parameters) would move the server between merges and upload
    zero deltas. Every payload must be nonzero, and the server must move
    only at a merge."""
    x, y, data, _ = _problem("logreg", 16, 4, 256)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    red = _WatchedMerge(decay=0.5)
    cfg = TrainConfig(**_cfg(async_mode=True, straggler_frac=0.25,
                             straggler_slowdown=2.0, **kw))
    engine = Engine(make_async(get_algorithm(cfg.algo)), cfg,
                    topology=Star(reducer=red))
    backend = TR.EventBackend(
        lambda p, b: logreg.loss_fn(p, b, _LAM), logreg.init_params(16),
        {k: torch.from_numpy(v) for k, v in data.items()},
        lambda p: logreg.full_objective(p, xt, yt, _LAM), device="cpu",
        merge_reducer=red)
    hist = engine.run(backend)
    assert len(red.log) == engine.report.rounds_total > 20
    assert not any(moved for moved, _ in red.log)
    assert all(norm > 0.0 for _, norm in red.log)
    assert hist[-1].value < hist[0].value


def test_async_dropout_same_seed_identical():
    x, y, data, _ = _problem("logreg", 16, 4, 256)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cfg = TrainConfig(**_cfg(async_mode=True, momentum=0.5,
                             dropout_rate=0.25, straggler_frac=0.25,
                             straggler_slowdown=2.0, reducer="int8"))
    runs = [TR.run(lambda p, b: logreg.loss_fn(p, b, _LAM),
                   logreg.init_params(16),
                   {k: torch.from_numpy(v) for k, v in data.items()}, cfg,
                   lambda p: logreg.full_objective(p, xt, yt, _LAM),
                   device="cpu", eval_every=4) for _ in range(2)]
    assert runs[0].trace == runs[1].trace
    assert any(e[1] == "drop" for e in runs[0].trace)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)))


def test_runtime_refusals():
    x, y, data, _ = _problem("logreg", 8, 2, 64)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    args = (lambda p, b: logreg.loss_fn(p, b, _LAM), logreg.init_params(8),
            tdata)
    ev = lambda p: torch.zeros(())
    for kw, exc, match in (
            (dict(async_mode=True, topology="streaming"), ValueError,
             "flat star"),
            (dict(async_mode=True, count_downlink=True), ValueError,
             "count_downlink"),
            (dict(async_mode=True, upload_schedule="streaming"), ValueError,
             "upload_schedule"),
            (dict(async_mode=True, reducer="topk"), ValueError, "int<b>"),
            (dict(algo="adaptive", dropout_rate=0.1), ValueError,
             "AdaptivePeriod"),
            (dict(async_mode=True, topology="hier"), ValueError,
             "flat star")):
        with pytest.raises(exc, match=match):
            TR.run(*args, TrainConfig(**_cfg(**kw)), ev, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        TR.run(*args, TrainConfig(**_cfg(async_mode=True)), ev,
               device="cpu", topology="star")


# ---------------------------------------------------------------------------
# the adaptive period on the event clock, and gradient diversity
# ---------------------------------------------------------------------------

def test_adaptive_runtime_matches_jax():
    cfg = _cfg(algo="adaptive", T1=24, k1=4.0, straggler_frac=0.25,
               straggler_slowdown=2.0, reducer="int8")
    jres, tres = _run_pair(cfg)
    _check(jres, tres, 1e-4)
    # the replayed rounds carry the triggered round lengths: some rounds
    # fired before the k-cap
    stages = get_algorithm("adaptive").stages(TrainConfig(**cfg))
    assert tres.rounds > sum(-(-s.T // s.k) for s in stages)


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_gradient_diversity_matches_jax(model):
    jm, tm = _MODELS[model]
    x, y, data, jp0 = _problem(model, 12, 4, 64)
    ref = float(jpart.gradient_diversity(
        {k: jnp.asarray(v) for k, v in data.items()},
        jax.grad(lambda p, d: jm.loss_fn(p, d, _LAM)),
        jax.tree.map(lambda a: jnp.asarray(a) + 0.1, jp0)))
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a) + 0.1,
                                      to_numpy_tree(jp0)))
    ours = float(gradient_diversity(
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.func.grad(lambda p, d: tm.loss_fn(p, d, _LAM)), tp))
    assert ref > 0.0
    assert ours == pytest.approx(ref, rel=1e-5)
