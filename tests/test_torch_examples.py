"""The port's quickstart and hierarchical-pods examples against the JAX
package's calls.

Each test imports the ported script (``examples_torch/``) as a module and
runs its sections on the CPU at the script's widths, with stages and
rounds cut; the JAX side is composed from ``repro.*`` calls with the same
constants at the same cut (the JAX scripts run module-level code for
minutes, so they are not imported). The port draws through ``JaxKey``,
replaying the reference's threefry draws. Tolerances:

  * f*: 1e-6 relative — both run 4,000 float32 gradient steps on one
    objective, in another summation order;
  * histories: 1e-5 absolute (dense) and 1e-4 (int8: a code may flip at
    a floor() boundary), as ``tests/test_torch_simulate.py`` states them;
    the (round, iteration) pairs equal, and the rounds to the script's
    target and to coarser gaps that the cut reaches equal;
  * ``topology_for(cfg).summary`` rows and the ``StagewiseDriver`` run's
    ``comm_bytes_total`` / ``leaf_ledger``: equal (pure arithmetic on the
    same integers and floats);
  * that run's consensus gap: 1e-4 absolute (its int8 inter-pod hop).
"""
import itertools

import jax
import jax.numpy as jnp
import pytest

from jax_replay import (JaxKey, close_histories, load_example,  # noqa: F401
                        one_torch_thread, same_rounds_to_target)
from repro.configs.base import TrainConfig as JCfg
from repro.core import local_sgd as JLS
from repro.core import simulate as JS
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.core.stl_sgd import driver_state as j_driver_state
from repro.core.stl_sgd import make_client_sgd_step as j_client_step
from repro.data import make_binary_classification as j_make_data
from repro.data import partition_iid as j_partition_iid
from repro.engine import topology_for as j_topology_for
from repro.models import logreg as jlogreg

qs = load_example("quickstart")
hp = load_example("hierarchical_pods")

# the cuts: rounds, or stages, of each run (widths are the scripts')
QS_CUTS = {"sync": dict(max_rounds=256), "local": dict(max_rounds=32),
           "stl_sc": dict(n_stages=2)}
HP_STAGES, HP_DRIVER_STAGES = 2, 2
# the script's target and the coarser gaps a cut run reaches
GAPS = (qs.TARGET, 3e-1, 1e-1, 3e-2, 1e-2, 3e-3, 1e-3)


def jax_problem(n, d, n_clients, lam):
    """The scripts' problem through the JAX package, and its f*."""
    x, y = j_make_data(n=n, d=d, seed=0)
    data = {k: jnp.asarray(v)
            for k, v in j_partition_iid(x, y, n_clients).items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    eval_fn = jax.jit(lambda p: jlogreg.full_objective(p, xj, yj, lam))
    p0 = jlogreg.init_params(None, d)
    gd = jax.jit(lambda p: jax.tree.map(lambda a, g: a - 2.0 * g, p,
                                        jax.grad(eval_fn)(p)))
    p = p0
    for _ in range(4000):
        p = gd(p)
    return {"loss_fn": lambda p, b: jlogreg.loss_fn(p, b, lam),
            "eval_fn": eval_fn, "p0": p0, "data": data,
            "fstar": float(eval_fn(p))}


@pytest.fixture(scope="module")
def quickstart():
    prob = qs.problem("cpu")
    return prob, qs.optimum(prob), jax_problem(qs.N, qs.D, qs.N_CLIENTS,
                                               qs.LAM)


@pytest.fixture(scope="module")
def pods():
    prob = hp.problem("cpu")
    return prob, hp.optimum(prob), jax_problem(hp.N, hp.D, hp.N_CLIENTS,
                                               hp.LAM)


@pytest.mark.parametrize("example", ["quickstart", "pods"])
def test_optimum_matches_jax(example, request):
    _, fstar, jp = request.getfixturevalue(example)
    assert fstar == pytest.approx(jp["fstar"], rel=1e-6)


@pytest.mark.parametrize("algo", [a for a, _ in qs.ALGOS])
def test_quickstart_compare_matches_jax(quickstart, algo):
    prob, fstar, jp = quickstart
    kw = dict(dict(qs.ALGOS)[algo])
    cut = dict(QS_CUTS[algo])
    kw.update(n_stages=cut.pop("n_stages", kw["n_stages"]))
    max_rounds = cut.pop("max_rounds", qs.MAX_ROUNDS)
    got = qs.compare(prob, fstar, [(algo, kw)], max_rounds=max_rounds,
                     device="cpu", rng=JaxKey(jax.random.key(0)))
    hist, rounds, _ = got[algo]
    want = JS.run(jp["loss_fn"], jp["p0"], jp["data"],
                  JCfg(algo=algo, eta1=0.5, T1=512, iid=True,
                       batch_per_client=32, seed=0, **kw), jp["eval_fn"],
                  eval_every=qs.EVAL_EVERY, max_rounds=max_rounds,
                  target=jp["fstar"] + qs.TARGET,
                  lr_alpha=1e-3 if algo in ("sync", "local") else 0.0)
    close_histories(hist, want, 1e-5)
    assert rounds == JS.rounds_to_target(want, jp["fstar"] + qs.TARGET)
    same_rounds_to_target(hist, want, jp["fstar"], GAPS)
    assert hist[-1].value < hist[0].value


@pytest.mark.parametrize("name", [n for n, _ in hp.CONFIGS])
def test_pods_compare_matches_jax(pods, name):
    prob, fstar, jp = pods
    kw = dict(hp.CONFIGS)[name]
    schedule = dict(hp.SIM_SCHEDULE, n_stages=HP_STAGES)
    got = hp.compare(prob, fstar, [(name, kw)], schedule, device="cpu",
                     rng=JaxKey(jax.random.key(0)))
    hist, summ = got[name]
    jcfg = JCfg(**schedule, iid=True, batch_per_client=32, seed=0, **kw)
    want = JS.run(jp["loss_fn"], jp["p0"], jp["data"], jcfg, jp["eval_fn"],
                  eval_every=hp.EVAL_EVERY)
    close_histories(hist, want, 1e-4 if "int8" in name else 1e-5)
    assert summ == j_topology_for(jcfg).summary(jp["p0"], hp.N_CLIENTS,
                                                want[-1].round)
    assert [h["hop"] for h in summ["hops"]] == (
        ["intra_pod", "inter_pod"] if kw["topology"] == "hier"
        else ["uplink"])


def test_pods_driver_matches_jax(pods):
    prob, fstar, jp = pods
    schedule = dict(hp.DRIVER_SCHEDULE, n_stages=HP_DRIVER_STAGES)
    ds, gap = hp.driver(prob, fstar, schedule, device="cpu",
                        rng=JaxKey(jax.random.key(1)),
                        sync_rng=JaxKey(jax.random.key(0)))
    jcfg = JCfg(**schedule, iid=True, batch_per_client=32, seed=0,
                topology="hier", reducer="dense", inter_reducer="int8",
                n_pods=hp.N_PODS)
    want = JDriver(jcfg, jax.jit(j_client_step(jp["loss_fn"], jp["data"],
                                               batch=32)),
                   jax.jit(JLS.build_sync_step(
                       "dense", hierarchical=True, n_pods=hp.N_PODS,
                       inter_reducer="int8"))).run(
        j_driver_state(jp["p0"], hp.N_CLIENTS), itertools.repeat(None))
    assert [(r.k, r.iters, r.rounds) for r in ds.results] == \
        [(r.k, r.iters, r.rounds) for r in want.results]
    assert ds.comm_bytes_total == want.comm_bytes_total > 0
    assert ds.leaf_ledger == want.leaf_ledger
    assert ds.comm_time_s == want.comm_time_s
    jgap = float(jp["eval_fn"](jax.tree.map(lambda x: x[0],
                                            want.state["params"]))) \
        - jp["fstar"]
    assert gap == pytest.approx(jgap, abs=1e-4)
    assert gap < float(prob["eval_fn"](prob["p0"])) - fstar


def test_pods_driver_only_flag_skips_the_simulator(monkeypatch, capsys):
    """``--driver`` runs only the driver section, as the JAX script's."""
    ran = []
    monkeypatch.setattr(hp, "optimum", lambda prob: 0.0)
    monkeypatch.setattr(hp, "compare", lambda *a, **k: ran.append("sim"))
    monkeypatch.setattr(hp, "driver",
                        lambda *a, **k: ran.append("driver") or (None, 0.0))
    out = hp.main(["--driver", "--device", "cpu"])
    assert ran == ["driver"] and set(out) == {"driver"}
    assert "2 pods of 4" in capsys.readouterr().out
