"""The port's simulator slice against the JAX package's, end to end.

Both packages start from the same weights (``params_from_jax``) and see
the same draws (a ``JaxKey`` replaying the JAX key schedule: chunk, round,
step, client, and the reducer's ``fold_in``). Tolerances on the history
objectives:

  * dense: 1e-5 — the runs differ only in float32 summation order
    (matmul, mean), ~1e-7 per step;
  * int8: 1e-4 — the codes are computed in the same op order, but those
    ulp-level differences in the parameters can move a value across an
    integer boundary of floor(); one such flipped code moves one
    coordinate of the consensus by scale/(qmax·N), which error feedback
    then carries back over the next rounds.

The ``EngineReport`` integers (rounds, iterations, modeled bytes, stages)
must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, to_numpy_tree
from repro.configs.base import TrainConfig as JCfg
from repro.core import simulate as JS
from repro.data import make_binary_classification as j_make_data
from repro.data import partition_iid as j_partition
from repro.engine import Engine as JEngine
from repro.models import logreg as jlogreg
from repro.models import mlp as jmlp
from repro_torch.configs.base import TrainConfig
from repro_torch.core import simulate as TS
from repro_torch.data import make_binary_classification, partition_iid
from repro_torch.data import partition_paper
from repro_torch.engine import Engine
from repro_torch.models import logreg, mlp
from repro_torch.utils.convert import params_from_jax

_MODELS = {"logreg": (jlogreg, logreg), "mlp": (jmlp, mlp)}
_LAM = 1e-3


def _problem(d, N, n=256):
    x, y = make_binary_classification(n=n, d=d, seed=0)
    return x, y, partition_iid(x, y, N, seed=1)


def _run_pair(model, cfg_kw, *, d=32, N=4, width=16, lr_alpha=0.0):
    jm, tm = _MODELS[model]
    x, y, data = _problem(d, N)
    if model == "logreg":
        jp0 = jlogreg.init_params(None, d)
    else:
        jp0 = jmlp.init_params(jax.random.key(42), d, width=width, depth=3)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jeng = JEngine(cfg_kw["algo"], JCfg(**cfg_kw))
    jhist = jeng.run(JS.VmapSimulatorBackend(
        lambda p, b: jm.loss_fn(p, b, _LAM), jp0,
        {k: jnp.asarray(v) for k, v in data.items()},
        jax.jit(lambda p: jm.full_objective(p, xj, yj, _LAM)),
        lr_alpha=lr_alpha, chunk_rounds=4))

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    teng = Engine(cfg_kw["algo"], TrainConfig(**cfg_kw))
    thist = teng.run(TS.VmapSimulatorBackend(
        lambda p, b: tm.loss_fn(p, b, _LAM),
        params_from_jax(to_numpy_tree(jp0)),
        {k: torch.from_numpy(v) for k, v in data.items()},
        lambda p: tm.full_objective(p, xt, yt, _LAM), device="cpu",
        lr_alpha=lr_alpha, chunk_rounds=4,
        rng=JaxKey(jax.random.key(cfg_kw.get("seed", 0)))))
    return jeng, jhist, teng, thist


def _check(jeng, jhist, teng, thist, tol):
    assert [(r.round, r.iteration) for r in thist] == \
        [(r.round, r.iteration) for r in jhist]
    np.testing.assert_allclose([r.value for r in thist],
                               [r.value for r in jhist], atol=tol, rtol=0)
    jr, tr = jeng.report, teng.report
    assert (tr.rounds_total, tr.iters_total, tr.comm_bytes_total,
            tr.stages_run) == (jr.rounds_total, jr.iters_total,
                               jr.comm_bytes_total, jr.stages_run)
    assert tr.comm_time_s == pytest.approx(jr.comm_time_s, rel=1e-12)
    assert teng.leaf_ledger() == jeng.leaf_ledger()


_STL = dict(algo="stl_sc", eta1=0.5, T1=16, k1=4.0, n_stages=2,
            batch_per_client=8, seed=0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("reducer,tol", [("dense", 1e-5), ("int8", 1e-4)])
def test_logreg_stl_sc_matches_jax(reducer, tol, momentum):
    out = _run_pair("logreg", dict(_STL, reducer=reducer, momentum=momentum))
    _check(*out, tol)
    jr = out[0].report
    assert jr.rounds_total == 8
    if reducer == "int8":
        assert jr.comm_bytes_total == 8 * 4 * (32 + 4)


def test_mlp_int8_streaming_star_matches_jax():
    jeng, jhist, teng, thist = _run_pair(
        "mlp", dict(_STL, reducer="int8", topology="streaming"))
    _check(jeng, jhist, teng, thist, 1e-4)
    assert len(teng.report.leaf_costs) == 8
    assert thist[-1].value < 0.9 * thist[0].value


def test_prox_lr_decay_and_growing_batch_match_jax():
    """stl_nc1 (prox re-centered per stage) with η/(1+α·t) decay, and
    CR-PSGD's masked growing batch — the rest of the round function."""
    out = _run_pair("logreg", dict(algo="stl_nc1", eta1=0.4, T1=8, k1=2.0,
                                   n_stages=2, batch_per_client=8,
                                   gamma_inv=0.5, seed=2), lr_alpha=1e-2)
    _check(*out, 1e-5)
    out = _run_pair("logreg", dict(algo="crpsgd", eta1=0.4, T1=6, k1=1.0,
                                   n_stages=1, batch_per_client=2,
                                   batch_growth=1.5, max_batch=8, seed=1))
    _check(*out, 1e-5)


def test_loss_and_grad_match_jax():
    d, B = 24, 8
    rng = np.random.RandomState(0)
    x = rng.randn(B, d).astype(np.float32)
    y = np.where(rng.rand(B) > 0.5, 1.0, -1.0).astype(np.float32)
    jp = jmlp.init_params(jax.random.key(1), d, width=16, depth=3)
    tp = params_from_jax(to_numpy_tree(jp))
    for jm, tm, jparams, tparams in (
            (jmlp, mlp, jp, tp),
            (jlogreg, logreg, {"theta": jnp.asarray(x[0])},
             {"theta": torch.from_numpy(x[0].copy())})):
        jl, jg = jax.value_and_grad(
            lambda p: jm.loss_fn(p, {"x": x, "y": y}, _LAM))(jparams)
        tl = tm.loss_fn(tparams, {"x": torch.from_numpy(x),
                                  "y": torch.from_numpy(y)}, _LAM)
        tg = torch.func.grad(lambda p: tm.loss_fn(
            p, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            _LAM))(tparams)
        assert float(tl) == pytest.approx(float(jl), abs=1e-6)
        for a, b in zip(jax.tree.leaves(jg), _leaves(tg)):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-6)
    # margin 0 (theta = 0): softplus' slope is exactly 1/2, as in JAX
    g0 = torch.func.grad(lambda t: logreg.softplus(t).sum())(torch.zeros(3))
    assert torch.equal(g0, torch.full((3,), 0.5))


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves

    return tree_leaves(tree)


def test_data_copies_match_jax_package():
    x, y = make_binary_classification(n=300, d=20, seed=3)
    jx, jy = j_make_data(n=300, d=20, seed=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    for a, b in zip(partition_iid(x, y, 5, seed=2).values(),
                    j_partition(jx, jy, 5, seed=2).values()):
        np.testing.assert_array_equal(a, b)
    from repro.data import partition_paper as j_paper

    for a, b in zip(partition_paper(x, y, 4, 50.0, seed=1).values(),
                    j_paper(jx, jy, 4, 50.0, seed=1).values()):
        np.testing.assert_array_equal(a, b)


def test_torch_key_run_is_deterministic_and_converges():
    """The default key (seeded torch.Generator) on the CPU: two runs with
    one seed give one history; the objective falls."""
    x, y, data = _problem(16, 4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    cfg = TrainConfig(**dict(_STL, reducer="int8", topology="streaming"))

    def once():
        return TS.run(lambda p, b: logreg.loss_fn(p, b, _LAM),
                      logreg.init_params(16), tdata, cfg,
                      lambda p: logreg.full_objective(p, xt, yt, _LAM),
                      device="cpu")

    h1, h2 = once(), once()
    assert [r.value for r in h1] == [r.value for r in h2]
    assert h1[-1].value < 0.9 * h1[0].value
    assert TS.rounds_to_target(h1, h1[-1].value) == h1[-1].round


def test_adaptive_and_async_are_refused():
    x, y, data = _problem(8, 2, n=64)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    for algo, exc in (("adaptive", NotImplementedError),
                      ("stl_sc+async", ValueError)):
        with pytest.raises(exc):
            TS.run(lambda p, b: logreg.loss_fn(p, b, _LAM),
                   logreg.init_params(8), tdata,
                   TrainConfig(**dict(_STL, algo=algo)),
                   lambda p: torch.zeros(()), device="cpu")


def test_replica_divergence_matches_jax():
    rng = np.random.RandomState(4)
    jp = jmlp.init_params(jax.random.key(3), 12, width=8, depth=2)
    stacked = jax.tree.map(
        lambda a: (a[None] + 0.1 * rng.randn(5, *a.shape)).astype(np.float32),
        to_numpy_tree(jp))
    ref = float(JS.replica_divergence(jax.tree.map(jnp.asarray, stacked)))
    ours = float(TS.replica_divergence(params_from_jax(stacked)))
    assert ours == pytest.approx(ref, rel=1e-5)
    same = TS.replica_divergence(
        params_from_jax(jax.tree.map(lambda a: np.repeat(a[:1], 5, 0),
                                     stacked)))
    assert float(same) < 1e-12     # a mean of equal copies rounds
