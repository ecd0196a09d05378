"""The port's StagewiseDriver, baselines, token data, checkpoints and
training launcher against the JAX package's.

* ``StagewiseDriver`` on both packages' transformer steps (qwen3-14b
  SMOKE, float32, 2 clients) over the same batches, from the same state
  (``train_state_from_jax``), the sync keys replaying JAX's
  (``JaxKey``): ``StageResult`` stage / k / iters / rounds / η equal,
  mean losses within 1e-5 relative (1e-4 with an int8 hop, where a code
  may flip: the local steps sum in another order, and under jit XLA
  rewrites the dequantization an ulp off), ``comm_bytes_total``,
  ``comm_time_s`` and ``leaf_ledger`` equal (the same arithmetic on the
  same leaves), final params within 1e-5 on dense runs. Every refusal of
  the reference raises in the port too. ``make_client_sgd_step`` over the
  same draws: params within 1e-5 (1e-4 with an int8 hop).
* ``make_token_stream``, ``batch_iterator``, ``synthetic_batches`` and
  ``crpsgd_batch_sizes``: equal arrays and lists (the same numpy draws).
* Checkpoints: a port-written file loads into the JAX template and a
  JAX-written one into the port's, bf16 leaves included, arrays equal.
* ``launch.train.main`` on qwen3-14b SMOKE (bf16, 4 clients, 8 steps),
  both started from the JAX package's initial state: equal stages, rounds,
  iterations and ledger; mean losses within 2e-2 (bf16 rounds each
  product to 8 bits; the two packages round in other places; measured
  1.2e-3 at a loss of 5.67).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import baselines as JB
from repro.core import local_sgd as JLS
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.data import synthetic as JD
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import baselines as TB
from repro_torch.core import local_sgd as TLS
from repro_torch.core.stl_sgd import StagewiseDriver, driver_state
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TT
from repro_torch.utils.convert import train_state_from_jax
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

C, B, S = 2, 2, 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    tcfg = get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    jstate = JLS.init_state(jax.random.key(0), jcfg, C)
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1))[0])
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(16):
        toks = rng.randint(0, jcfg.vocab_size, (C, B, S + 1))
        batches.append({"tokens": toks[..., :-1].astype(np.int32),
                        "labels": toks[..., 1:].astype(np.int32)})
    return jcfg, tcfg, jstate, jstep, batches


# (algo, topology, reducer, inter reducer, driver factory)
DRIVERS = {
    "stl_sc star": ("stl_sc", "star", "dense", None, None),
    "stl_sc streaming": ("stl_sc", "streaming", "dense", None, None),
    "stl_sc star int8": ("stl_sc", "star", "int8", None, None),
    "stl_sc hier": ("stl_sc", "hier", "dense", "int8", None),
    "syncsgd": ("sync", "star", "dense", None, "sync_sgd_driver"),
    "lbsgd": ("lb", "star", "dense", None, "lb_sgd_driver"),
}


def _sync_steps(reducer, topology, inter):
    kw = dict(streaming=topology == "streaming")
    if inter is not None:
        kw.update(hierarchical=True, n_pods=2, inter_reducer=inter)
    return (jax.jit(JLS.build_sync_step(reducer, **kw)),
            TLS.build_sync_step(reducer, rng=JaxKey(jax.random.key(0)),
                                **kw))


@pytest.mark.parametrize("case", list(DRIVERS))
def test_driver_matches_jax(setup, case):
    jcfg, tcfg, jstate, jstep, batches = setup
    algo, topology, reducer, inter, factory = DRIVERS[case]
    kw = dict(algo=algo, eta1=0.05, T1=4, k1=2.0, n_stages=2,
              topology=topology, reducer=reducer,
              inter_reducer=inter or "int8")
    jsync, tsync = _sync_steps(reducer, topology, inter)
    tstep = TLS.build_train_steps(tcfg, "cpu")[0]
    if factory:
        jdrv = getattr(JB, factory)(JTrainConfig(**kw), jstep, jsync)
        tdrv = getattr(TB, factory)(TrainConfig(**kw), tstep, tsync)
    else:
        jdrv = JDriver(JTrainConfig(**kw), jstep, jsync)
        tdrv = StagewiseDriver(TrainConfig(**kw), tstep, tsync)
    assert tdrv.span_attrs == jdrv.span_attrs
    want = jdrv.run(jstate, iter([jax.tree.map(jnp.asarray, b)
                                  for b in batches]))
    got = tdrv.run(train_state_from_jax(to_numpy_tree(jstate), "cpu"),
                   iter([{k: torch.from_numpy(v).long() for k, v in b.items()}
                         for b in batches]))
    tol = 1e-4 if "int8" in (reducer, inter) else 1e-5
    assert len(got.results) == len(want.results) == 2
    for a, b in zip(got.results, want.results):
        assert (a.stage, a.k, a.iters, a.rounds, a.eta) == \
            (b.stage, b.k, b.iters, b.rounds, b.eta)
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=tol)
    assert (got.rounds_total, got.iters_total) == \
        (want.rounds_total, want.iters_total)
    assert got.comm_bytes_total == want.comm_bytes_total
    assert got.comm_time_s == want.comm_time_s
    assert got.leaf_ledger == want.leaf_ledger and len(got.leaf_ledger) > 0
    if tol == 1e-5:
        for (path, a), b in zip(tree_flatten_with_path(got.state["params"])[0],
                                jax.tree.leaves(want.state["params"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5, err_msg=path)


def _toy_step(state, batch, eta):
    return dict(state, step=state["step"] + 1), {"loss": 0.0}


REFUSALS = {   # TrainConfig kwargs, sync-step kwargs, message
    "async": (dict(algo="stl_sc+async"), {}, "asynchronous"),
    "adaptive": (dict(algo="adaptive"), {}, "divergence probe"),
    "flat step, hier config": (dict(algo="local", topology="hier"), {},
                               "build_sync_step"),
    "n_pods": (dict(algo="local", topology="hier", n_pods=4),
               dict(hierarchical=True, n_pods=2), "n_pods"),
    "inter_reducer": (dict(algo="local", topology="hier",
                           inter_reducer="dense"),
                      dict(hierarchical=True, n_pods=2,
                           inter_reducer="int8"), "inter_reducer"),
    "unknown topology": (dict(algo="local", topology="ring"), {},
                         "unknown topology"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_driver_refusals_match_jax(case):
    cfg_kw, sync_kw, match = REFUSALS[case]
    for cfg_cls, build, driver in (
            (JTrainConfig, JLS.build_sync_step, JDriver),
            (TrainConfig, TLS.build_sync_step, StagewiseDriver)):
        with pytest.raises(ValueError, match=match):
            driver(cfg_cls(**cfg_kw), _toy_step, build(None, **sync_kw))


def test_hier_tagged_step_implies_hierarchical_under_star_config():
    sync = TLS.build_sync_step(None, hierarchical=True, n_pods=2,
                               inter_reducer="int8")
    drv = StagewiseDriver(TrainConfig(algo="local", T1=4, k1=2.0,
                                      n_stages=1), _toy_step, sync)
    assert drv.hierarchical and drv.n_pods == 2
    assert drv.inter_reducer.name == "int8"
    state = driver_state({"w": torch.ones(3, 4), "b": torch.zeros(4)}, 4)
    state["params"]["w"] += torch.arange(4.0)[:, None, None]
    ds = drv.run(state, itertools.repeat(None))
    assert ds.rounds_total == 2
    assert {l["hop"] for l in ds.leaf_ledger} == {"intra_pod", "inter_pod"}
    assert sum(l["bytes"] for l in ds.leaf_ledger) == ds.comm_bytes_total


@pytest.mark.parametrize("inter", ["dense", "int8"])
def test_client_sgd_step_driver_matches_jax(inter):
    """``make_client_sgd_step`` + ``driver_state`` (the harness of the
    reference's hierarchical demos) on a logreg problem over 4 clients in
    2 pods: the same minibatch draws (``JaxKey``), params within 1e-5
    (1e-4 with the int8 WAN hop), the same ledger."""
    from repro.core.stl_sgd import driver_state as j_driver_state
    from repro.core.stl_sgd import make_client_sgd_step as j_client_step
    from repro.models import logreg as JL
    from repro_torch.core.stl_sgd import make_client_sgd_step
    from repro_torch.models import logreg as TL

    rng = np.random.RandomState(7)
    data = {"x": rng.randn(4, 64, 12).astype(np.float32),
            "y": np.sign(rng.randn(4, 64)).astype(np.float32)}
    p0 = {"theta": (0.1 * rng.randn(12)).astype(np.float32)}
    cfg = dict(algo="stl_sc", eta1=0.2, T1=4, k1=2.0, n_stages=2,
               topology="hier", n_pods=2, inter_reducer=inter)
    jsync, tsync = _sync_steps("dense", "hier", inter)
    want = JDriver(JTrainConfig(**cfg), j_client_step(
        lambda p, b: JL.loss_fn(p, b, 1e-3),
        jax.tree.map(jnp.asarray, data), 8), jsync).run(
        j_driver_state(jax.tree.map(jnp.asarray, p0), 4),
        itertools.repeat(None))
    got = StagewiseDriver(TrainConfig(**cfg), make_client_sgd_step(
        lambda p, b: TL.loss_fn(p, b, 1e-3),
        {k: torch.from_numpy(v) for k, v in data.items()}, 8,
        rng=JaxKey(jax.random.key(1))), tsync).run(
        driver_state({k: torch.from_numpy(v) for k, v in p0.items()}, 4),
        itertools.repeat(None))
    tol = 1e-4 if inter == "int8" else 1e-5
    assert [(r.k, r.iters, r.rounds) for r in got.results] == \
        [(r.k, r.iters, r.rounds) for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=tol)
    for a, b in zip(tree_leaves(got.state["params"]),
                    jax.tree.leaves(want.state["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol)
    assert got.leaf_ledger == want.leaf_ledger
    assert got.comm_bytes_total == want.comm_bytes_total


# ---------------------------------------------------------------------------
# Token data and the CR-PSGD schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("non_iid", [False, True])
def test_token_data_equals_jax(non_iid):
    got = TD.make_token_stream(5000, 97, 3, seed=4, non_iid=non_iid)
    want = JD.make_token_stream(5000, 97, 3, seed=4, non_iid=non_iid)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for (gx, gy), (wx, wy) in itertools.islice(
            zip(TD.batch_iterator(got[0], 4, 16, seed=5),
                JD.batch_iterator(want[0], 4, 16, seed=5)), 3):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_synthetic_batches_equal_jax():
    cfg = get_arch("qwen3-14b", smoke=True)
    jcfg = jax_get_arch("qwen3-14b", smoke=True)
    for got, want in itertools.islice(
            zip(TT.synthetic_batches(cfg, 3, 2, 16, seed=6, device="cpu"),
                JT.synthetic_batches(jcfg, 3, 2, 16, seed=6)), 3):
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.long and got[k].shape == (3, 2, 16)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("args", [(8, 1.1, 40, 512), (32, 1.5, 12, 96),
                                  (3, 2.0, 10, 64, 4)])
def test_crpsgd_batch_sizes_equal_jax(args):
    assert TB.crpsgd_batch_sizes(*args) == JB.crpsgd_batch_sizes(*args)


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_state():
    jcfg = jax_get_arch("qwen3-14b", smoke=True)   # bf16 leaves
    jstate = JLS.init_state(jax.random.key(1), jcfg, 2)
    jstate = dict(jstate, step=jnp.asarray(3, jnp.int32))
    return jstate, train_state_from_jax(to_numpy_tree(jstate), "cpu")


def test_port_checkpoint_loads_into_jax_template(tmp_path, bf16_state):
    jstate, tstate = bf16_state
    assert tstate["step"] == 3
    save_checkpoint(str(tmp_path), 7, tstate, {"algo": "stl_sc"})
    assert latest_step(str(tmp_path)) == 7
    loaded, meta = j_load(str(tmp_path), jstate)
    assert meta == {"algo": "stl_sc"}
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_jax_checkpoint_loads_into_port_template(tmp_path, bf16_state):
    jstate, tstate = bf16_state
    j_save(str(tmp_path), 9, jstate, {"rounds": 2})
    template = dict(tstate, step=0)
    loaded, meta = load_checkpoint(str(tmp_path), template)
    assert meta == {"rounds": 2} and loaded["step"] == 3
    got = tree_leaves([loaded["params"], loaded["opt"]])
    want = tree_leaves([tstate["params"], tstate["opt"]])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), template)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_train_main_matches_jax(monkeypatch):
    argv = ["--arch", "qwen3-14b", "--smoke", "--steps", "8"]
    want = JT.main(argv)
    jcfg = jax_get_arch("qwen3-14b", smoke=True)

    def from_jax(seed, cfg, n, optimizer, *, device=None):
        return train_state_from_jax(to_numpy_tree(
            JLS.init_state(jax.random.key(seed), jcfg, n, optimizer)), device)

    monkeypatch.setattr(TLS, "init_state", from_jax)
    got = TT.main(argv + ["--device", "cpu"])
    assert [(r.stage, r.k, r.iters, r.rounds) for r in got.results] == \
        [(r.stage, r.k, r.iters, r.rounds) for r in want.results] == \
        [(1, 4, 8, 2)]
    for a, b in zip(got.results, want.results):
        assert a.mean_loss == pytest.approx(b.mean_loss, abs=2e-2)
    assert got.comm_bytes_total == want.comm_bytes_total
