"""Mamba2 training in the port against the JAX package.

* The SSD autograd Function (``kernels/ssd/ops.ssd``): its gradients in
  x, dt, A, B, C and the initial state against ``jax.grad`` of the JAX
  model's chunked scan ``ssd_chunked`` (S a multiple of the chunk, which
  that scan asserts), from a zero and from a given state, and at a ragged
  S (a short last chunk, which only the port's scan takes) against
  ``jax.grad`` of the reference's sequential ``ssd_ref``. Every gradient
  within 1e-5 of its largest magnitude (float32; the same function summed
  in another order). A loss that reaches only y, or only
  the final state, gets the same gradients as JAX's.
* ``build_train_steps`` / ``StagewiseDriver`` on mamba2-2.7b SMOKE
  (float32, 2 clients, 64 tokens: one chunk) from the JAX package's
  initial state (``train_state_from_jax``), the sync keys replaying JAX's
  (``JaxKey``): the parity contract's limits — stage results and ledgers
  equal, mean losses within 1e-5 relative (1e-4 with an int8 hop, where a
  code may flip), final params within 1e-5 on dense runs.
* ``local_sgd.init_state`` on kind ``M``: the grouped layout, the same
  leaves as the reference's state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import local_sgd as JLS
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.launch.mesh import make_host_mesh
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import local_sgd as TLS
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_vjp_ref
from repro_torch.utils.convert import train_state_from_jax
from repro_torch.utils.tree import tree_flatten_with_path

NAMES = ("x", "dt", "A", "B", "C", "initial_state")


def _inputs(b, S, H, P, G, N, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, S, H, P) * 0.5).astype(np.float32),
            (np.logaddexp(rng.randn(b, S, H), 0.0) * 0.1).astype(np.float32),
            (-np.exp(rng.randn(H) * 0.3)).astype(np.float32),
            (rng.randn(b, S, G, N) * 0.3).astype(np.float32),
            (rng.randn(b, S, G, N) * 0.3).astype(np.float32),
            rng.randn(b, H, P, N).astype(np.float32),
            rng.randn(b, S, H, P).astype(np.float32),    # dL/dy
            rng.randn(b, H, P, N).astype(np.float32))    # dL/dstate


def _torch_grads(arrays, chunk, init, use):
    """The port's gradients of sum(gy·y) + sum(gs·state) (the terms in
    ``use``), one per input that requires grad."""
    x, dt, A, B, C, h0, gy, gs = arrays
    ins = [torch.from_numpy(a.copy()).requires_grad_()
           for a in (x, dt, A, B, C, h0)[:6 if init else 5]]
    y, st = ssd(*ins[:5], chunk=chunk,
                initial_state=ins[5] if init else None)
    loss = sum(torch.sum(o * torch.from_numpy(g))
               for o, g, name in ((y, gy, "y"), (st, gs, "state"))
               if name in use)
    return torch.autograd.grad(loss, ins)


def _jax_grads(fn, arrays, init, use):
    x, dt, A, B, C, h0, gy, gs = arrays

    def loss(*a):
        y, st = fn(*a[:5], a[5] if init else None)
        return sum(jnp.sum(o * g) for o, g, name in ((y, gy, "y"),
                                                     (st, gs, "state"))
                   if name in use)

    args = (x, dt, A, B, C, h0)[:6 if init else 5]
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _assert_close(got, want, tol=1e-5):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        if not b.any():   # the final state does not reach C: zero in both
            assert not a.numpy().any(), f"d{name}"
            continue
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= tol, f"d{name}: {err}"


@pytest.mark.parametrize("use", [("y", "state"), ("y",), ("state",)])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(128, 64), (256, 128), (64, 64)])
def test_ssd_gradients_match_jax_chunked(S, chunk, init, use):
    arrays = _inputs(2, S, 4, 16, 1, 8, seed=S + chunk)
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_chunked(
        x, dt, A, B, C, chunk, h0), arrays, init, use)
    _assert_close(_torch_grads(arrays, chunk, init, use), want)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,G", [(100, 1), (130, 2), (37, 1)])
def test_ssd_gradients_at_a_ragged_length_match_jax_ref(S, G, init):
    """A short last chunk (S not a multiple of the chunk, grouped B/C):
    held to the reference's sequential oracle, differentiated."""
    arrays = _inputs(1, S, 4, 16, G, 8, seed=S)
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_ref(
        x, dt, A, B, C, initial_state=h0), arrays, init, ("y", "state"))
    _assert_close(_torch_grads(arrays, 64, init, ("y", "state")), want)


def _vjp_passes_grads(arrays, chunk, init, use):
    """``ref.ssd_chunked_vjp_ref`` (the backward kernel's passes in plain
    PyTorch) for the loss of ``_torch_grads``."""
    x, dt, A, B, C, h0, gy, gs = (None if a is None else
                                  torch.from_numpy(a.copy()) for a in arrays)
    got = ssd_chunked_vjp_ref(x, dt, A, B, C, chunk, h0 if init else None,
                              gy if "y" in use else None,
                              gs if "state" in use else None)
    return got[:6 if init else 5]


@pytest.mark.parametrize("use", [("y", "state"), ("y",), ("state",)])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(128, 64), (256, 128), (64, 64)])
def test_ssd_vjp_passes_match_jax_chunked(S, chunk, init, use):
    """The backward kernel's algorithm (reverse state passing, dCB per
    group, M's row and column sums, the seg terms against the last row's)
    against ``jax.grad`` of the JAX model's chunked scan, as the Function's
    gradients are held above."""
    arrays = _inputs(2, S, 4, 16, 1, 8, seed=S + chunk)
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_chunked(
        x, dt, A, B, C, chunk, h0), arrays, init, use)
    _assert_close(_vjp_passes_grads(arrays, chunk, init, use), want)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,G", [(100, 1), (130, 2), (37, 1)])
def test_ssd_vjp_passes_at_a_ragged_length_match_jax_ref(S, G, init):
    arrays = _inputs(1, S, 4, 16, G, 8, seed=S)
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_ref(
        x, dt, A, B, C, initial_state=h0), arrays, init, ("y", "state"))
    _assert_close(_vjp_passes_grads(arrays, 64, init, ("y", "state")), want)


def test_ssd_vjp_passes_under_a_strong_decay_match_jax_ref():
    """dt x 10: exp(cums) falls to about 1e-30 within a chunk of 100 rows.
    d(dt A) sums dcums back over the chunk, where L's row and column sums
    and the seg terms cancel; held within 1e-5 as the other gradients."""
    x, dt, A, B, C, _, gy, _ = _inputs(1, 300, 4, 16, 1, 8, seed=11)
    arrays = (x, dt * 10, A, B, C, None, gy, None)
    assert np.exp((arrays[1][0, :100] * A).sum(0)).min() < 1e-25
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_ref(
        x, dt, A, B, C, initial_state=h0), arrays, False, ("y",))
    _assert_close(_vjp_passes_grads(arrays, 100, False, ("y",)), want)


def test_ssd_keeps_the_return_types_under_grad():
    arrays = _inputs(1, 64, 2, 16, 1, 8)
    x = torch.from_numpy(arrays[0]).to(torch.bfloat16).requires_grad_()
    rest = [torch.from_numpy(a) for a in arrays[1:5]]
    y, st = ssd(x, *rest, chunk=64)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    (dx,) = torch.autograd.grad(y.float().sum(), [x])
    assert dx.dtype == torch.bfloat16 and bool(torch.isfinite(dx).all())


# ---------------------------------------------------------------------------
# Training steps and the driver on mamba2 SMOKE
# ---------------------------------------------------------------------------

C_, B_, S_ = 2, 2, 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch("mamba2-2.7b", smoke=True).replace(dtype="float32")
    tcfg = get_arch("mamba2-2.7b", smoke=True).replace(dtype="float32")
    jstate = JLS.init_state(jax.random.key(0), jcfg, C_)
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1))[0])
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(12):
        toks = rng.randint(0, jcfg.vocab_size, (C_, B_, S_ + 1))
        batches.append({"tokens": toks[..., :-1].astype(np.int32),
                        "labels": toks[..., 1:].astype(np.int32)})
    return jcfg, tcfg, jstate, jstep, batches


@pytest.mark.parametrize("reducer", ["dense", "int8"])
def test_mamba2_driver_matches_jax(setup, reducer):
    jcfg, tcfg, jstate, jstep, batches = setup
    kw = dict(algo="stl_sc", eta1=0.05, T1=4, k1=2.0, n_stages=2,
              reducer=reducer)
    jsync = jax.jit(JLS.build_sync_step(reducer))
    tsync = TLS.build_sync_step(reducer, rng=JaxKey(jax.random.key(0)))
    tstep = TLS.build_train_steps(tcfg, "cpu")[0]
    want = JDriver(JTrainConfig(**kw), jstep, jsync).run(
        jstate, iter([jax.tree.map(jnp.asarray, b) for b in batches]))
    got = StagewiseDriver(TrainConfig(**kw), tstep, tsync).run(
        train_state_from_jax(to_numpy_tree(jstate), "cpu"),
        iter([{k: torch.from_numpy(v).long() for k, v in b.items()}
              for b in batches]))
    tol = 1e-4 if reducer == "int8" else 1e-5
    assert [(r.stage, r.k, r.iters, r.rounds, r.eta) for r in got.results] \
        == [(r.stage, r.k, r.iters, r.rounds, r.eta) for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=tol)
    assert got.comm_bytes_total == want.comm_bytes_total
    assert got.comm_time_s == want.comm_time_s
    assert got.leaf_ledger == want.leaf_ledger and len(got.leaf_ledger) > 0
    if reducer == "dense":
        for (path, a), b in zip(tree_flatten_with_path(got.state["params"])[0],
                                jax.tree.leaves(want.state["params"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5, err_msg=path)


def test_mamba2_init_state_has_the_reference_leaves():
    jcfg = jax_get_arch("mamba2-2.7b", smoke=True)
    tcfg = get_arch("mamba2-2.7b", smoke=True)
    want = JLS.init_state(jax.random.key(0), jcfg, 3)
    got = TLS.init_state(0, tcfg, 3, device="cpu")
    for part in ("params", "opt"):
        wl = jax.tree_util.tree_flatten_with_path(want[part])[0]
        gl = tree_flatten_with_path(got[part])[0]
        assert [jax.tree_util.keystr(p) for p, _ in wl] == [p for p, _ in gl]
        for (_, a), (path, b) in zip(wl, gl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    # equal replicas, zero moments
    for leaf in (t for _, t in tree_flatten_with_path(got["params"])[0]):
        assert torch.equal(leaf[0], leaf[2])


def test_ssd_gradients_stay_finite_where_a_chunk_decays_past_exp_range():
    """dt·A summed over a chunk below about -88: exp of the segment sums'
    upper triangle overflows. The JAX model's chunked scan selects after
    the exp, so its gradient in dt and A is 0·inf = NaN; the port masks
    before the exp and matches ``jax.grad`` of the sequential oracle,
    within 1e-4 of each gradient's largest magnitude (the chunked and the
    sequential forms round decays that span e^-96 in other orders; 1.6e-5
    measured on dA)."""
    x, _, _, B, C, _, gy, _ = _inputs(1, 64, 2, 8, 1, 4, seed=9)
    dt = np.full((1, 64, 2), 3.0, np.float32)
    A = np.array([-1.0, -0.5], np.float32)
    arrays = (x, dt, A, B, C, None, gy, None)
    chunked = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_chunked(
        x, dt, A, B, C, 64, h0), arrays, False, ("y",))
    assert not np.isfinite(np.asarray(chunked[1])).all()
    want = _jax_grads(lambda x, dt, A, B, C, h0: j_ssd_ref(
        x, dt, A, B, C, initial_state=h0), arrays, False, ("y",))
    got = _torch_grads(arrays, 64, False, ("y",))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_close(got, want, tol=1e-4)
