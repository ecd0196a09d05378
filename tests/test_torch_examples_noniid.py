"""The port's federated Non-IID example against the JAX package's calls.

The ported script's sections run on the CPU at its widths with stages and
rounds cut; the JAX side is composed from ``repro.*`` calls with the same
constants at the same cut, and the port draws through ``JaxKey``.
Tolerances:

  * ζ (gradient diversity at x0) and f*: 1e-6 relative; ``theory_k1`` on
    the same ζ equal (pure arithmetic), and on each side's own ζ within
    1e-6 relative;
  * histories: 1e-5 absolute (dense) and 1e-4 (int8, top-k: a code may
    flip at a floor() boundary, an element at the k-th magnitude may swap
    with its neighbour), with equal rounds to the target and to the
    coarser gaps the cut reaches;
  * ``comm_summary_for`` rows: equal (pure arithmetic).

The event-runtime sections are held in
``tests/test_torch_examples_runtime.py``.
"""
import jax
import jax.numpy as jnp
import pytest

from jax_replay import (JaxKey, close_histories, load_example,  # noqa: F401
                        one_torch_thread, same_rounds_to_target)
from repro.comm import comm_summary_for as j_comm_summary_for
from repro.configs.base import TrainConfig as JCfg
from repro.core import schedules as JSched
from repro.core import simulate as JS
from repro.data import make_binary_classification as j_make_data
from repro.data.partition import gradient_diversity as j_diversity
from repro.data.partition import partition_paper as j_partition_paper
from repro.models import logreg as jlogreg

fed = load_example("federated_noniid")

CUTS = {"sync": dict(max_rounds=256), "local": dict(max_rounds=64),
        "stl_sc": dict(n_stages=2)}
REDUCER_STAGES = 1
# the script's target and the coarser gaps a cut run reaches
GAPS = (fed.TARGET, 3e-1, 1e-1, 3e-2, 1e-2, 3e-3, 1e-3)


@pytest.fixture(scope="module")
def noniid():
    prob = fed.problem("cpu")
    x, y = j_make_data(n=fed.N_SAMPLES, d=fed.D, seed=0)
    data = {k: jnp.asarray(v) for k, v in j_partition_paper(
        x, y, fed.N, iid_percent=50.0, seed=1).items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    loss_fn = lambda p, b: jlogreg.loss_fn(p, b, fed.LAM)  # noqa: E731
    eval_fn = jax.jit(lambda p: jlogreg.full_objective(p, xj, yj, fed.LAM))
    p0 = jlogreg.init_params(None, fed.D)
    gd = jax.jit(lambda p: jax.tree.map(lambda a, g: a - 2.0 * g, p,
                                        jax.grad(eval_fn)(p)))
    p = p0
    for _ in range(4000):
        p = gd(p)
    jp = {"loss_fn": loss_fn, "eval_fn": eval_fn, "p0": p0, "data": data,
          "x": xj, "y": yj, "fstar": float(eval_fn(p))}
    return prob, fed.optimum(prob), jp


def test_heterogeneity_and_optimum_match_jax(noniid):
    prob, fstar, jp = noniid
    zeta, k1_hom, k1_non = fed.heterogeneity(prob)
    jzeta = float(j_diversity(
        jp["data"], lambda p, d: jax.grad(lambda q: jp["loss_fn"](q, d))(p),
        jp["p0"]))
    assert zeta == pytest.approx(jzeta, rel=1e-6)
    kw = dict(sigma=1.0, iid=False)
    assert k1_hom == JSched.theory_k1(fed.ETA1, fed.L, fed.N, zeta=0.0, **kw)
    assert k1_non == JSched.theory_k1(fed.ETA1, fed.L, fed.N, zeta=zeta,
                                      **kw)
    assert k1_non == pytest.approx(JSched.theory_k1(
        fed.ETA1, fed.L, fed.N, zeta=jzeta, **kw), rel=1e-6)
    assert k1_non < k1_hom
    assert fstar == pytest.approx(jp["fstar"], rel=1e-6)


@pytest.mark.parametrize("algo", [a for a, _ in fed.ALGOS])
def test_noniid_compare_matches_jax(noniid, algo):
    prob, fstar, jp = noniid
    kw = dict(dict(fed.ALGOS)[algo])
    cut = dict(CUTS[algo])
    kw.update(n_stages=cut.pop("n_stages", kw["n_stages"]))
    max_rounds = cut.pop("max_rounds", fed.MAX_ROUNDS)
    hist, rounds = fed.compare(prob, fstar, [(algo, kw)],
                               max_rounds=max_rounds, device="cpu",
                               rng=JaxKey(jax.random.key(0)))[algo]
    want = JS.run(jp["loss_fn"], jp["p0"], jp["data"],
                  JCfg(algo=algo, eta1=fed.ETA1, T1=512, iid=False,
                       batch_per_client=32, seed=0, **kw), jp["eval_fn"],
                  eval_every=fed.EVAL_EVERY, max_rounds=max_rounds,
                  target=jp["fstar"] + fed.TARGET,
                  lr_alpha=1e-3 if algo in ("sync", "local") else 0.0)
    close_histories(hist, want, 1e-5)
    assert rounds == JS.rounds_to_target(want, jp["fstar"] + fed.TARGET)
    same_rounds_to_target(hist, want, jp["fstar"], GAPS)


@pytest.mark.parametrize("red", fed.REDUCERS)
def test_noniid_reducers_match_jax(noniid, red):
    prob, fstar, jp = noniid
    schedule = dict(fed.REDUCER_SCHEDULE, n_stages=REDUCER_STAGES)
    hist, summ = fed.reducers(prob, fstar, [red], schedule, device="cpu",
                              rng=JaxKey(jax.random.key(0)))[red]
    jcfg = JCfg(**schedule, iid=False, batch_per_client=32, seed=0,
                reducer=red)
    want = JS.run(jp["loss_fn"], jp["p0"], jp["data"], jcfg, jp["eval_fn"],
                  eval_every=fed.EVAL_EVERY, max_rounds=fed.MAX_ROUNDS,
                  target=jp["fstar"] + fed.TARGET)
    close_histories(hist, want, 1e-5 if red == "dense" else 1e-4)
    same_rounds_to_target(hist, want, jp["fstar"], GAPS)
    assert summ == j_comm_summary_for(jcfg, jp["p0"], fed.N, want[-1].round)
