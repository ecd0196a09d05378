"""The port's RG-LRU block and recurrentgemma-2b against the JAX package.

* ``models/rglru.apply_rglru`` against ``repro.models.rglru.apply_rglru``
  on the same params (``params_from_jax``) and inputs from a numpy seed,
  float32: without a cache, a prefill from a given state and conv carry,
  and a single-token decode step; the output, the final state and the
  conv carry within 1e-5. The port's log-depth doubling scan and
  ``lax.associative_scan`` associate the products differently, so the
  parity is to rounding, not bitwise. The gate is jax.nn.gelu's default,
  the tanh approximation: the exact GELU misses the tolerance (a control).
* The scan at a decay the random init reaches (a from about 1e-14 to 1)
  equals the sequential recurrence, and its forward and its gradient in
  ``a_param`` stay finite.
* recurrentgemma-2b SMOKE (R, R, L; window 64) in float32, the JAX params
  carried across by ``transformer_params_from_jax``: ``forward``, and an
  80-token ``prefill`` (past the window) then 8 ``decode_step`` calls,
  logits within 1e-5 (measured 1.6e-6); a prefill into a used cache row
  equals a fresh one's; greedy tokens equal the reference's.
* ``local_sgd.lm_loss`` and the gradient of every leaf (``a_param``, the
  float32 leaf, among them) against ``jax.value_and_grad`` of the
  reference's: the loss 1e-5 relative, each leaf 1e-5 of its largest
  |gradient|.
* ``StagewiseDriver`` on recurrentgemma-2b SMOKE (2 clients, stl_sc, 2
  stages) against the reference's from the same state and batches, the
  sync keys replaying JAX's (``JaxKey``): stage results equal, mean losses
  within 1e-5 relative under dense Star, 1e-4 under int8 Star; final
  params within 1e-5 on the dense run; ledgers equal.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jax_replay import JaxKey, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import local_sgd as JLS
from repro.core.serving import greedy_decode as j_greedy
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.launch.mesh import make_host_mesh
from repro.models import rglru as JRG
from repro.models import transformer as JTF
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import local_sgd as TLS
from repro_torch.core import serving as TS
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.models import rglru as TRG
from repro_torch.models import transformer as TTF
from repro_torch.utils.convert import (params_from_jax, train_state_from_jax,
                                       transformer_params_from_jax)
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_path,
                                    tree_leaves)

ARCH = "recurrentgemma-2b"
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs():
    return (jax_get_arch(ARCH, smoke=True).replace(dtype="float32"),
            get_arch(ARCH, smoke=True).replace(dtype="float32"))


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs()
    jp = JRG.init_rglru(jax.random.key(3), jcfg, jnp.float32)
    return jcfg, tcfg, jp, params_from_jax(to_numpy_tree(jp))


def _cache(cfg, B, seed):
    lru, K = cfg.rglru.lru_width, cfg.rglru.d_conv
    rng = np.random.RandomState(seed)
    return {"conv": rng.randn(B, K - 1, lru).astype(np.float32),
            "state": (rng.randn(B, lru) * 0.5).astype(np.float32)}


def _run_both(block, S, cached, gelu=None):
    jcfg, tcfg, jp, tp = block
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    c = _cache(jcfg, 2, S + 1) if cached else None
    want, jc = JRG.apply_rglru(
        jp, jcfg, jnp.asarray(x),
        None if c is None else jax.tree.map(jnp.asarray, c))
    tc = None if c is None else {k: torch.from_numpy(v.copy())
                                 for k, v in c.items()}
    with (mock.patch.object(F, "gelu", gelu) if gelu
          else contextlib.nullcontext()):
        got, tc = TRG.apply_rglru(tp, tcfg, torch.from_numpy(x), tc)
    return got, np.asarray(want), tc, jc


@pytest.mark.parametrize("S,cached", [(37, False), (37, True), (1, True)],
                         ids=["no cache", "prefill from a state", "decode"])
def test_apply_rglru_matches_jax(block, S, cached):
    got, want, tc, jc = _run_both(block, S, cached)
    assert got.shape == want.shape == (2, S, block[0].d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if cached:
        assert tc["state"].dtype == torch.float32
        np.testing.assert_allclose(tc["state"].numpy(),
                                   np.asarray(jc["state"]), **TOL)
        np.testing.assert_allclose(tc["conv"].numpy(),
                                   np.asarray(jc["conv"]), **TOL)


def test_exact_gelu_misses_the_tolerance(block):
    """A control: torch's default GELU (the exact erf form) in place of
    jax.nn.gelu's tanh approximation is caught at 1e-5."""
    gelu = F.gelu
    exact = lambda x, approximate="none": gelu(x)
    got, want, _, _ = _run_both(block, 37, False, gelu=exact)
    assert np.abs(got.numpy() - want).max() > 1e-5


def test_scan_equals_the_recurrence_and_stays_finite():
    """a from about 1e-14 (r near 1, softplus(4)·8 ≈ 32) to 1, S = 300 (9
    doubling passes, the last partial): the doubling scan equals the
    sequential recurrence from a given state, and the forward and the
    gradient in a_param and the inputs are finite."""
    rng = np.random.RandomState(0)
    B, S, W = 2, 300, 16
    r = torch.from_numpy(rng.rand(B, S, W).astype(np.float32))
    i = torch.from_numpy(rng.rand(B, S, W).astype(np.float32))
    xb = torch.from_numpy(rng.randn(B, S, W).astype(np.float32))
    a_param = torch.full((W,), 4.0, requires_grad=True)
    h0 = torch.from_numpy(rng.randn(B, W).astype(np.float32))
    h, final = TRG._rg_lru_scan(xb, r, i, a_param, h0)
    a, b = TRG._gates(a_param.detach(), r, i, xb)
    assert float(a.min()) < 1e-13 and float(a.max()) > 0.99
    want, st = [], h0
    for t in range(S):
        st = a[:, t] * st + b[:, t]
        want.append(st)
    np.testing.assert_allclose(h.detach().numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-6,
                               rtol=1e-5)
    assert torch.equal(final, h[:, -1])
    (g,) = torch.autograd.grad((h * torch.cos(h)).sum(), a_param)
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# recurrentgemma-2b SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(to_numpy_tree(jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_config_and_layout(model):
    """(R, R, L) at SMOKE's 3 layers; at full width 8 groups and a tail of
    two R layers, which the grouped layout and the JAX template share."""
    jcfg, tcfg, _, tp = model
    assert tcfg.layer_kinds() == ("R", "R", "L")
    assert sorted(tp["layers"][0]) == ["ln1", "ln2", "lru", "mlp"]
    assert sorted(tp["layers"][0]["lru"]) == sorted(
        ["w_x", "w_gate_lru", "conv_lru", "w_a", "w_i", "a_param",
         "w_out_lru"])
    full = get_arch(ARCH)
    head, n_groups, pattern, tail = TTF._plan(full)
    assert (head, n_groups, pattern, tail) == ((), 8, ("R", "R", "L"),
                                              ("R", "R"))
    p = TTF.init_params(tcfg.replace(dtype="bfloat16"), seed=0, device="cpu")
    types = {path: t.dtype for path, t in tree_flatten_with_path(p)[0]}
    assert {k for k, t in types.items() if t != torch.bfloat16} == {
        "['layers'][0]['lru']['a_param']", "['layers'][1]['lru']['a_param']"}


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 80)
    want, _ = JTF.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TTF.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_past_the_window_match_jax(model):
    """An 80-token prompt (past the 64-token window) then 8 decode steps:
    the recurrent layers decode through the closed update, the local
    layer's ring wraps."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 80, seed=1)
    jc = JTF.init_cache(jcfg, 2, 100)
    tc = TTF.init_cache(tcfg, 2, 100, device="cpu")
    assert tc["layers"][0]["state"].dtype == torch.float32
    assert tc["layers"][0]["conv"].shape == (2, 3, 256)
    want, jc = JTF.prefill(jp, jcfg, jnp.asarray(toks), jc)
    got, tc = TTF.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    for _ in range(8):
        want, jc = JTF.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        got, tc = TTF.decode_step(tp, tcfg, torch.from_numpy(tok.copy())
                                  .long(), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want, axis=-1))
    assert tc["pos"].tolist() == [88, 88] and int(jc["pos"]) == 88
    for layer in (0, 1):
        np.testing.assert_allclose(
            tc["layers"][layer]["state"].numpy(),
            np.asarray(jc["blocks"][f"sub{layer}"]["state"][0]), **TOL)


def test_used_row_prefill_equals_a_fresh_one(model):
    """A row that served a request (its recurrent state, conv carry and
    K/V written) and then takes a new prompt gives the logits and the
    cache of a fresh row: ``prefill`` zeroes the R layers' carry and
    state."""
    _, tcfg, _, tp = model
    used = TTF.init_cache(tcfg, 2, 100, device="cpu")
    first = torch.from_numpy(_tokens(tcfg, 1, 70, seed=2)).long()
    TTF.prefill(tp, tcfg, first, TTF.cache_rows(used, 1, 2))
    TTF.decode_step(tp, tcfg, torch.tensor([[3], [5]]), used)
    assert used["layers"][0]["state"][1].abs().max() > 0
    toks = torch.from_numpy(_tokens(tcfg, 1, 30, seed=3)).long()
    got, _ = TTF.prefill(tp, tcfg, toks, TTF.cache_rows(used, 1, 2))
    fresh = TTF.init_cache(tcfg, 1, 100, device="cpu")
    want, _ = TTF.prefill(tp, tcfg, toks, fresh)
    assert torch.equal(got, want)
    for kind, c, f in zip(tcfg.layer_kinds(), used["layers"],
                          fresh["layers"]):
        if kind == "R":
            assert torch.equal(c["state"][1:2], f["state"])
            assert torch.equal(c["conv"][1:2], f["conv"])


def test_greedy_tokens_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens(jcfg, 1, 70, seed=4)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(prompt), 10, 96))
    got, _ = TS.greedy_decode(tp, tcfg, torch.from_numpy(prompt).long(), 10,
                              96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_loss_and_gradients_match_jax(model):
    jcfg, tcfg, jp, _ = model
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 81))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    want_loss, want = jax.value_and_grad(lambda p: JLS.lm_loss(
        p, jcfg, jax.tree.map(jnp.asarray, batch)))(jp)
    tp = params_from_jax(to_numpy_tree(jp))
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    loss = TLS.lm_loss(tp, tcfg, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert sum("a_param" in p for p in paths) == 2   # sub0, sub1
    for path, a, b in zip(paths, got, jax.tree.leaves(want)):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= 1e-5, f"{path}: {err}"


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

C, B, S = 2, 2, 32


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jstate = JLS.init_state(jax.random.key(0), jcfg, C)
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1))[0])
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(12):
        toks = rng.randint(0, jcfg.vocab_size, (C, B, S + 1))
        batches.append({"tokens": toks[..., :-1].astype(np.int32),
                        "labels": toks[..., 1:].astype(np.int32)})
    return jcfg, tcfg, jstate, jstep, batches


@pytest.mark.parametrize("reducer", ["dense", "int8"])
def test_driver_matches_jax(setup, reducer):
    jcfg, tcfg, jstate, jstep, batches = setup
    kw = dict(algo="stl_sc", eta1=0.05, T1=4, k1=2.0, n_stages=2,
              reducer=reducer)
    jdrv = JDriver(JTrainConfig(**kw), jstep,
                   jax.jit(JLS.build_sync_step(reducer)))
    tdrv = StagewiseDriver(TrainConfig(**kw),
                           TLS.build_train_steps(tcfg, "cpu")[0],
                           TLS.build_sync_step(
                               reducer, rng=JaxKey(jax.random.key(0))))
    want = jdrv.run(jstate, iter([jax.tree.map(jnp.asarray, b)
                                  for b in batches]))
    got = tdrv.run(train_state_from_jax(to_numpy_tree(jstate), "cpu"),
                   iter([{k: torch.from_numpy(v).long() for k, v in b.items()}
                         for b in batches]))
    tol = 1e-4 if reducer == "int8" else 1e-5
    assert len(got.results) == len(want.results) == 2
    for a, b in zip(got.results, want.results):
        assert (a.stage, a.k, a.iters, a.rounds, a.eta) == \
            (b.stage, b.k, b.iters, b.rounds, b.eta)
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=tol)
    assert (got.comm_bytes_total, got.comm_time_s, got.leaf_ledger) == \
        (want.comm_bytes_total, want.comm_time_s, want.leaf_ledger)
    if reducer == "dense":
        got_leaves = tree_flatten_with_path(got.state["params"])[0]
        for (path, a), b in zip(got_leaves,
                                jax.tree.leaves(want.state["params"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5, err_msg=path)


def test_transformer_params_from_jax_carry_the_tail():
    """At a depth of 5 (one group and a tail of R, R) every JAX leaf lands
    in the port's layer list: the tail's lru leaves included."""
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = jcfg.replace(n_layers=5), tcfg.replace(n_layers=5)
    jp = to_numpy_tree(JTF.init_params(jax.random.key(1), jcfg))
    tp = transformer_params_from_jax(jp, tcfg, "cpu")
    assert [sorted(l) for l in tp["layers"]] == \
        [["ln1", "ln2", "lru", "mlp"]] * 2 + [["attn", "ln1", "ln2", "mlp"]] \
        + [["ln1", "ln2", "lru", "mlp"]] * 2
    np.testing.assert_array_equal(tp["layers"][4]["lru"]["w_a"].numpy(),
                                  jp["tail"][1]["lru"]["w_a"])
    np.testing.assert_array_equal(tp["layers"][1]["lru"]["a_param"].numpy(),
                                  jp["blocks"]["sub1"]["lru"]["a_param"][0])
    back = TTF.to_grouped(tp, tcfg)
    assert len(tree_leaves(back)) == len(jax.tree.leaves(jp))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
