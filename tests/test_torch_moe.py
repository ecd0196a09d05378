"""The port's MoE layer against the JAX package's.

phi3.5-moe and deepseek-v2 SMOKE in float32 (deepseek with its shared
expert), the JAX ``init_moe`` params carried across. ``apply_moe`` (B = 3
rows, each its own capacity pool) and ``_moe_pool`` against the
reference's: the output and aux within 1e-5 (float32 products summed in
another order), the expert assignment (top-k experts, rank within the
expert, kept or dropped) equal. Dropless (the SMOKE configs'
``capacity_factor`` 64) and dropping (1.0 and 0.5, where some assignments
go to the sink row). Gradients of every MoE leaf and of the input against
``jax.grad``, within 1e-5 of the leaf's largest |gradient|.

A token whose k-th and (k+1)-th router probabilities nearly tie could be
routed differently by two summation orders; the tests check that their
inputs' smallest such margin is far above float32 rounding instead of
hiding a flip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as JM
from repro_torch.configs import get_arch
from repro_torch.models import moe as TM
from repro_torch.utils.convert import params_from_jax

ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]
# the SMOKE configs' 64 (dropless), then two that drop assignments
CAPACITY = [None, 1.0, 0.5]
MARGIN = 1e-4   # the smallest top-k margin the inputs must keep


def _cfgs(name, capacity_factor=None):
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _margin(params, moe, x):
    """The smallest gap, over the tokens of x, between a token's k-th and
    (k+1)-th router probability: how close its assignment came to a tie."""
    probs = torch.softmax(x.float() @ params["w_router"], dim=-1)
    top = torch.topk(probs, moe.top_k + 1, dim=-1).values
    return float((top[..., moe.top_k - 1] - top[..., moe.top_k]).min())


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    jcfg, _ = _cfgs(request.param)
    jp = JM.init_moe(jax.random.key(0), jcfg, jnp.float32)
    return request.param, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _x(d, B=3, T=40, seed=1):
    return np.random.RandomState(seed).randn(B, T, d).astype(np.float32)


def _jax_assignment(params, moe, xt):
    """The reference's routing lines (``src/repro/models/moe.py:57-73``)
    for one pool: (idx, rank, keep)."""
    T = xt.shape[0]
    E, k = moe.n_experts, moe.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        params["w_router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = max(1, min(T, int(T * k / E * moe.capacity_factor)))
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(rank), np.asarray(rank < C)


def _check_assignment(jp, tp, jcfg, tcfg, x):
    r = TM.route(tp, tcfg.moe, torch.from_numpy(x))
    assert _margin(tp, tcfg.moe, torch.from_numpy(x)) > MARGIN
    for b in range(x.shape[0]):
        idx, rank, keep = _jax_assignment(jp, jcfg.moe, jnp.asarray(x[b]))
        np.testing.assert_array_equal(r.idx[b].numpy(), idx)
        np.testing.assert_array_equal(r.rank[b].numpy(), rank)
        np.testing.assert_array_equal(r.keep[b].numpy(), keep)
    return r


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_apply_moe_matches_jax(layer, capacity_factor):
    name, jp, tp = layer
    jcfg, tcfg = _cfgs(name, capacity_factor)
    x = _x(jcfg.d_model)
    r = _check_assignment(jp, tp, jcfg, tcfg, x)
    dropped = int((~r.keep).sum())
    assert (dropped == 0) == (capacity_factor is None)
    want, want_aux = JM.apply_moe(jp, jcfg, jnp.asarray(x))
    got, aux = TM.apply_moe(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_pool_matches_jax(layer, capacity_factor):
    """One pool of 96 tokens (the reference's flat pool), and the rows of
    ``apply_moe`` each equal to their own pool alone."""
    name, jp, tp = layer
    jcfg, tcfg = _cfgs(name, capacity_factor)
    xt = _x(jcfg.d_model, B=1, T=96, seed=2)[0]
    want, want_aux = JM._moe_pool(jp, jcfg.moe, jnp.asarray(xt))
    got, aux = TM._moe_pool(tp, tcfg.moe, torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-7)
    x = torch.from_numpy(_x(jcfg.d_model, seed=3))
    rows, _ = TM._moe_rows(tp, tcfg.moe, x)
    for b in range(x.shape[0]):
        alone, _ = TM._moe_pool(tp, tcfg.moe, x[b])
        np.testing.assert_allclose(rows[b].numpy(), alone.numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_gradients_match_jax(layer, capacity_factor):
    """d/d(leaf) of sum(y * g) + aux for every MoE leaf and the input; a
    dropped assignment's gradient is zero in both."""
    name, jp, tp = layer
    jcfg, tcfg = _cfgs(name, capacity_factor)
    x = _x(jcfg.d_model, seed=4)
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    _check_assignment(jp, tp, jcfg, tcfg, x)

    def jloss(p, xx):
        y, aux = JM.apply_moe(p, jcfg, xx)
        return jnp.sum(y * g) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tp)
    ins = [t.clone().requires_grad_() for _, t in leaves]
    xt = torch.from_numpy(x).requires_grad_()
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp), ins)
    y, aux = TM.apply_moe(tree, tcfg, xt)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux,
                              ins + [xt])
    paths = [jax.tree_util.keystr(p) for p, _ in leaves] + ["x"]
    for path, a, b in zip(paths, got, jax.tree.leaves(want_p) + [want_x]):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-5, f"{path}: {err}"


def test_capacity_truncates_as_the_reference():
    moe = get_arch("phi3.5-moe-42b-a6.6b", smoke=True).moe
    for T, cf, want in ((3, 1.25, 1), (40, 1.0, 20), (40, 0.5, 10),
                        (7, 0.9, 3), (1, 0.01, 1), (5, 64.0, 5)):
        assert TM.capacity(dataclasses.replace(moe, capacity_factor=cf),
                           T) == want
    assert TM.capacity(get_arch("deepseek-v2-236b").moe, 3000) == 140


def test_init_moe_layout_matches_jax():
    for name in ARCHS:
        jcfg, tcfg = _cfgs(name)
        jp = JM.init_moe(jax.random.key(0), jcfg, jnp.bfloat16)
        tp = TM.init_moe(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16)
        want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype))
                for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
        got = {jax.tree_util.keystr(p): (tuple(a.shape),
                                         str(a.dtype).split(".")[-1])
               for p, a in jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert got == want
        assert tp["w_router"].dtype == torch.float32


# -- training: the float32 router leaf in the client tree --------------------

@pytest.mark.parametrize("name", ARCHS)
def test_local_steps_and_rounds_match_jax(name):
    """Two local steps of 2 clients × 2 × 32 tokens from JAX's
    ``init_state``, then a dense round (params and moments within 1e-5)
    and, from the same replicas, an int8 round: the consensus within
    1e-6 and each leaf's residuals within a tenth of its largest (a
    flipped code moves one by a whole quantum). ``train_state_from_jax``
    carries every MoE leaf, the router's included."""
    from jax_replay import JaxKey, to_numpy_tree
    from repro.core import local_sgd as JLS
    from repro.launch.mesh import make_host_mesh
    from repro_torch.core import local_sgd as TLS
    from repro_torch.utils.convert import train_state_from_jax
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

    jcfg, tcfg = _cfgs(name)
    js = JLS.init_state(jax.random.key(0), jcfg, 2)
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1))[0])
    port = lambda s: train_state_from_jax(to_numpy_tree(s), "cpu")
    ts = port(js)
    # one router leaf, stacked over the groups of MoE layers
    assert sum(p.endswith("['w_router']")
               for p, _ in tree_flatten_with_path(ts["params"])[0]) == 1
    tstep = TLS.build_train_steps(tcfg, "cpu")[0]
    rng = np.random.RandomState(6)
    for _ in range(2):
        toks = rng.randint(0, jcfg.vocab_size, (2, 2, 33))
        b = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b), 0.05)
        ts, tm = tstep(ts, {k: torch.from_numpy(v).long()
                            for k, v in b.items()}, 0.05)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    int8_from = port(js)

    def close(tree, jtree, tol):
        got = tree_flatten_with_path(tree)[0]
        want = jax.tree_util.tree_flatten_with_path(jtree)[0]
        assert [p for p, _ in got] == [jax.tree_util.keystr(p)
                                       for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=tol, rtol=tol, err_msg=path)

    jd = JLS.build_sync_step("dense")(js)
    td = TLS.build_sync_step("dense")(ts)
    close(td["params"], jd["params"], 1e-5)
    close(td["opt"], jd["opt"], 1e-5)

    ji = JLS.build_sync_step("int8")(js)
    ti = TLS.build_train_steps(tcfg, "cpu", reducer="int8",
                               rng=JaxKey(jax.random.key(0)))[1](int8_from)
    close(ti["params"], ji["params"], 1e-6)
    for a, b in zip(tree_leaves(ti["comm"]["res"]),
                    jax.tree.leaves(ji["comm"]["res"])):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 0.1 * np.abs(b).max()
