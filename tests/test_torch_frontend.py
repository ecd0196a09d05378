"""The port's frontend archs against the JAX package.

internvl2-2b (vision patches) and musicgen-medium (audio frames) SMOKE in
float32, the JAX params carried across by ``transformer_params_from_jax``;
the frontend embeddings (16 of width 96 at SMOKE) come from a numpy seed.

* ``forward`` with the frontend, and a ``prefill`` with it (16 frontend
  plus 24 text tokens) then 8 ``decode_step`` calls: logits within 1e-5
  (measured 1.6e-6); ``cache["pos"]`` counts the frontend tokens. The
  logits with the frontend differ from those without it, in both packages
  alike: the frontend is not dropped. (Greedy tokens are no test of that at
  random weights: the reference's own ``test_greedy_decode_threads_frontend``
  gets the same tokens with and without it.)
* ``greedy_decode(..., frontend=)`` tokens equal the reference's.
* ``local_sgd.lm_loss`` with a bfloat16 frontend (as the launcher's
  batches carry it) and every gradient, ``proj_frontend``'s among them,
  against ``jax.value_and_grad`` of the reference's: 1e-5 (the loss
  relative, each leaf of its largest |gradient|).
* ``StagewiseDriver`` on musicgen-medium SMOKE with frontend batches
  (dense Star, 2 clients, microbatches of 1 row), against the reference's:
  mean losses 1e-5 relative, final params 1e-5, ledgers equal.
* internvl2-2b SMOKE behind ``ServeEngine`` with frontend requests: the
  ledger (tokens and every modeled time, the prefills priced with their
  frontend tokens) identical to the reference engine's, and each request's
  tokens equal to the port's ``greedy_decode`` on the bfloat16-rounded
  frontend.
* ``launch.train.synthetic_batches``' frontend leaf equals the
  reference's draws (bfloat16, the same values).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import local_sgd as JLS
from repro.core.serving import greedy_decode as j_greedy
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JTF
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve import DeviceModel as JDeviceModel
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import local_sgd as TLS
from repro_torch.core import serving as TS
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.launch import train as TT
from repro_torch.models import transformer as TTF
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (DeviceModel, Request, SchedulerConfig,
                               ServeEngine)
from repro_torch.utils.convert import (params_from_jax, train_state_from_jax,
                                       transformer_params_from_jax)
from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path

ARCHS = ["internvl2-2b", "musicgen-medium"]
TOL = dict(atol=1e-5, rtol=1e-5)
PRICES = dict(peak_flops=989e12, hbm_bw=3.35e12)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(to_numpy_tree(jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fe = rng.randn(B, cfg.n_frontend_tokens,
                   cfg.frontend_dim).astype(np.float32)
    return toks, fe


def test_forward_with_the_frontend_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(jcfg, 2, 24, 0)
    want, _ = JTF.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(fe))
    got, _ = TTF.forward(tp, tcfg, torch.from_numpy(toks).long(),
                         torch.from_numpy(fe))
    assert "proj_frontend" in tp
    assert got.shape == (2, 16 + 24, TTF.padded_vocab(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_with_the_frontend_match_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(jcfg, 2, 24, 1)
    jc = JTF.init_cache(jcfg, 2, 64)
    tc = TTF.init_cache(tcfg, 2, 64, device="cpu")
    want, jc = JTF.prefill(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(fe))
    got, tc = TTF.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc,
                          torch.from_numpy(fe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tc["pos"].tolist() == [40, 40] and int(jc["pos"]) == 40
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    for _ in range(8):
        want, jc = JTF.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        got, tc = TTF.decode_step(tp, tcfg, torch.from_numpy(tok.copy())
                                  .long(), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want, axis=-1))
    assert tc["pos"].tolist() == [48, 48] and int(jc["pos"]) == 48


def test_the_frontend_moves_the_logits(model):
    """The last position's logits of a prefill with the frontend against
    one without it, in both packages: they differ by far more than the
    packages differ from each other."""
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(jcfg, 1, 24, 2)
    out = {}
    for with_fe in (True, False):
        jfe = jnp.asarray(fe) if with_fe else None
        tfe = torch.from_numpy(fe) if with_fe else None
        want, _ = JTF.prefill(jp, jcfg, jnp.asarray(toks),
                              JTF.init_cache(jcfg, 1, 48), jfe)
        got, tc = TTF.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                              TTF.init_cache(tcfg, 1, 48, device="cpu"), tfe)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tc["pos"].tolist() == [40 if with_fe else 24]
        out[with_fe] = (got[0, -1, :tcfg.vocab_size].numpy(),
                        np.asarray(want)[0, -1, :jcfg.vocab_size])
    for i in (0, 1):
        assert np.abs(out[True][i] - out[False][i]).max() > 1e-2


def test_greedy_decode_with_the_frontend_equals_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(jcfg, 1, 20, 3)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(toks), 6, 48,
                               frontend=jnp.asarray(fe)))
    got, margins = TS.greedy_decode(tp, tcfg, torch.from_numpy(toks).long(),
                                    6, 48, frontend=torch.from_numpy(fe))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((margins > 1e-4).all())


def test_lm_loss_and_gradients_with_the_frontend_match_jax(model):
    jcfg, tcfg, jp, _ = model
    toks, fe = _inputs(jcfg, 2, 33, 4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = dict(jax.tree.map(jnp.asarray, batch),
              frontend=jnp.asarray(fe, jnp.bfloat16))
    want_loss, want = jax.value_and_grad(
        lambda p: JLS.lm_loss(p, jcfg, jb))(jp)
    tp = params_from_jax(to_numpy_tree(jp))
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tb["frontend"] = torch.from_numpy(fe).to(torch.bfloat16)
    loss = TLS.lm_loss(tp, tcfg, tb)
    got = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert "['proj_frontend']" in paths
    for path, a, b in zip(paths, got, jax.tree.leaves(want)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= 1e-5, f"{path}: {err}"
        if path == "['proj_frontend']":
            assert float(a.abs().max()) > 0


def test_driver_with_frontend_batches_matches_jax():
    name, C, B, S = "musicgen-medium", 2, 2, 24
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    jstate = JLS.init_state(jax.random.key(0), jcfg, C)
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1),
                                          microbatch=2)[0])
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(12):
        toks = rng.randint(0, jcfg.vocab_size, (C, B, S + 1))
        fe = rng.randn(C, B, jcfg.n_frontend_tokens, jcfg.frontend_dim)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:],
                        "frontend": fe.astype(np.float32)})
    kw = dict(algo="stl_sc", eta1=0.05, T1=4, k1=2.0, n_stages=2)
    want = JDriver(JTrainConfig(**kw), jstep,
                   jax.jit(JLS.build_sync_step())).run(
        jstate, iter([{k: jnp.asarray(v, jnp.bfloat16 if k == "frontend"
                                      else jnp.int32)
                       for k, v in b.items()} for b in batches]))
    tstep = TLS.build_train_steps(tcfg, "cpu", microbatch=2)[0]
    got = StagewiseDriver(TrainConfig(**kw), tstep,
                          TLS.build_sync_step()).run(
        train_state_from_jax(to_numpy_tree(jstate), "cpu"),
        iter([{k: (torch.from_numpy(v).to(torch.bfloat16) if k == "frontend"
                   else torch.from_numpy(v).long()) for k, v in b.items()}
              for b in batches]))
    assert [(r.stage, r.k, r.iters, r.rounds) for r in got.results] == \
        [(r.stage, r.k, r.iters, r.rounds) for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=1e-5)
    assert (got.comm_bytes_total, got.leaf_ledger) == \
        (want.comm_bytes_total, want.leaf_ledger)
    for (path, a), b in zip(tree_flatten_with_path(got.state["params"])[0],
                            jax.tree.leaves(want.state["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=path)


def test_engine_with_frontend_requests_matches_jax():
    """internvl2-2b SMOKE, 3 slots: 7 requests, each with its own patch
    embeddings (float32 from a seed), one without (a text-only request,
    priced without the frontend tokens); slots are reused."""
    name = "internvl2-2b"
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(1), jcfg)
    tp = transformer_params_from_jax(to_numpy_tree(jp), tcfg, "cpu")
    sched = dict(n_slots=3, max_seq_len=64, max_queue=16)
    rng = np.random.RandomState(5)
    reqs = []
    for i in range(7):
        fe = (None if i == 4 else rng.randn(
            tcfg.n_frontend_tokens, tcfg.frontend_dim).astype(np.float32))
        reqs.append(dict(id=i, arrival_s=(i + 1) * 1e-5,
                         prompt=rng.randint(0, tcfg.vocab_size, size=(
                             int(rng.randint(1, 30)),)).astype(np.int32),
                         n_out=int(rng.randint(1, 8)), frontend=fe))
    jeng = JServeEngine(jcfg, jp, scheduler=JSchedulerConfig(**sched),
                        device=JDeviceModel(**PRICES))
    teng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(**sched),
                       device=DeviceModel(**PRICES))
    treqs = [Request(**r) for r in reqs]
    jrep = jeng.run([JRequest(**r) for r in reqs], registry=JRegistry())
    trep = teng.run(treqs, registry=MetricsRegistry())
    assert len(trep.completed) == 7
    assert [teng.prefill_s(r) for r in treqs] == \
        [jeng.prefill_s(JRequest(**r)) for r in reqs]
    for r in treqs:
        n = r.prompt_len + (16 if r.frontend is not None else 0)
        assert teng.prefill_s(r) == teng.device.step_time_s(
            tcfg, ShapeConfig("serve_prefill", n, 1, "prefill"))
    assert trep.trace_keys() == jrep.trace_keys()
    assert (trep.n_steps, trep.n_prefills, trep.makespan_s) == \
        (jrep.n_steps, jrep.n_prefills, jrep.makespan_s)
    assert len({r.slot for r in trep.records}) < len(trep.records)
    for r, rec in zip(treqs, trep.records):
        fe = (None if r.frontend is None else
              torch.from_numpy(r.frontend[None]).to(torch.bfloat16))
        want, _ = TS.greedy_decode(tp, tcfg, torch.from_numpy(
            r.prompt[None]).long(), r.n_out, sched["max_seq_len"],
            frontend=fe)
        assert rec.tokens == want[0].tolist(), f"req {r.id}"


@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_batches_frontend_equals_jax(name):
    cfg, jcfg = get_arch(name, smoke=True), jax_get_arch(name, smoke=True)
    for got, want in itertools.islice(
            zip(TT.synthetic_batches(cfg, 2, 3, 16, seed=6, device="cpu"),
                JT.synthetic_batches(jcfg, 2, 3, 16, seed=6)), 2):
        assert sorted(got) == sorted(want) == ["frontend", "labels",
                                               "tokens"]
        fe = got["frontend"]
        assert fe.dtype == torch.bfloat16 and fe.shape == (2, 3, 16, 96)
        np.testing.assert_array_equal(fe.float().numpy(),
                                      np.asarray(want["frontend"],
                                                 np.float32))
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
