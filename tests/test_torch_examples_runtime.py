"""The port's federated Non-IID example, its event-runtime sections,
against the JAX package's calls.

The ported script's straggler and streaming sections run on the CPU at
its widths with stages and rounds cut; the JAX side runs ``repro.runtime``
with the same constants at the same cut, and the port draws through
``JaxKey``. Tolerances:

  * sync and async with stragglers: rounds (merges), iterations and
    ``wall_clock_s`` equal (pure arithmetic on the same floats),
    histories within 1e-5 absolute (float32 summation order);
  * the MLP's blocking against streaming uploads: bit-equal on the port,
    each within 1e-5 of the reference, its modeled wall and per-leaf
    ledger equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from jax_replay import (JaxKey, close_histories, load_example,  # noqa: F401
                        one_torch_thread, to_numpy_tree)
from repro import runtime as JR
from repro.configs.base import TrainConfig as JCfg
from repro.data import make_binary_classification as j_make_data
from repro.data.partition import partition_paper as j_partition_paper
from repro.models import logreg as jlogreg
from repro.models import mlp as jmlp
from repro_torch.utils.convert import params_from_jax

fed = load_example("federated_noniid")

STRAGGLER_CUTS = {"local": dict(max_rounds=32), "stl_sc": dict(n_stages=1)}
STREAM_STAGES = 1


@pytest.fixture(scope="module")
def noniid():
    """The script's problem on the CPU, and the same through the JAX
    package. The runtime sections read f* only to print the gap: 0 here."""
    x, y = j_make_data(n=fed.N_SAMPLES, d=fed.D, seed=0)
    data = {k: jnp.asarray(v) for k, v in j_partition_paper(
        x, y, fed.N, iid_percent=50.0, seed=1).items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jp = {"loss_fn": lambda p, b: jlogreg.loss_fn(p, b, fed.LAM),
          "eval_fn": jax.jit(lambda p: jlogreg.full_objective(
              p, xj, yj, fed.LAM)),
          "p0": jlogreg.init_params(None, fed.D), "data": data,
          "x": xj, "y": yj}
    return fed.problem("cpu"), 0.0, jp


@pytest.mark.parametrize("algo", [a for a, _ in fed.STRAGGLER_RUNS])
def test_noniid_stragglers_match_jax(noniid, algo):
    prob, fstar, jp = noniid
    kw = dict(dict(fed.STRAGGLER_RUNS)[algo])
    cut = dict(STRAGGLER_CUTS[algo])
    kw.update(n_stages=cut.pop("n_stages", kw["n_stages"]))
    max_rounds = cut.pop("max_rounds", None)
    got = fed.stragglers(prob, fstar, [(algo, kw)], max_rounds=max_rounds,
                         device="cpu", rng=JaxKey(jax.random.key(0)))
    for mode in ("sync", "async"):
        res = got[algo, mode]
        want = JR.run(jp["loss_fn"], jp["p0"], jp["data"],
                      JCfg(algo=algo, eta1=fed.ETA1, iid=False,
                           batch_per_client=32, seed=0,
                           async_mode=mode == "async", **fed.STRAGGLERS,
                           **kw), jp["eval_fn"], eval_every=64,
                      max_rounds=max_rounds)
        close_histories(res.history, want.history, 1e-5)
        assert (res.rounds, res.iters) == (want.rounds, want.iters)
        assert res.wall_clock_s == want.wall_clock_s
    # the barrier waits on the stragglers; merge-on-arrival does not
    assert got[algo, "async"].wall_clock_s < got[algo, "sync"].wall_clock_s


def test_noniid_streaming_matches_jax_and_blocking(noniid):
    prob, _, jp = noniid
    jp0 = jmlp.init_params(jax.random.key(42), fed.D)
    cfg = dataclasses.replace(fed.STREAM_CFG, n_stages=STREAM_STAGES)
    got = fed.streaming(prob, params_from_jax(to_numpy_tree(jp0)), cfg,
                        device="cpu", rng=JaxKey(jax.random.key(0)))
    blocking, stream = got["blocking"], got["streaming"]
    assert [r.value for r in blocking.history] == \
        [r.value for r in stream.history]
    assert stream.wall_clock_s < blocking.wall_clock_s
    jcfg = JCfg(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)})
    for sched, res in got.items():
        want = JR.run(lambda p, b: jmlp.loss_fn(p, b, fed.LAM), jp0,
                      jp["data"], dataclasses.replace(
                          jcfg, upload_schedule=sched),
                      jax.jit(lambda p: jmlp.full_objective(
                          p, jp["x"], jp["y"], fed.LAM)), eval_every=32)
        close_histories(res.history, want.history, 1e-5)
        assert res.wall_clock_s == want.wall_clock_s
        assert res.leaf_ledger == want.leaf_ledger
