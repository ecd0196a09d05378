"""The port's Local-SGD step builders against the JAX package's.

qwen3-14b SMOKE in float32; both packages start from the JAX package's
``init_state`` (carried across by ``train_state_from_jax``: the port
trains in the reference's grouped layout, so every leaf maps one to one)
and see the same numpy batches; the sync rounds' keys replay JAX's draws
(``JaxKey``). Tolerances:

  * dense and streaming rounds after k local steps: 1e-5 (float32
    products summed in another order over a few steps);
  * int8 trajectories: a code may flip where the two packages' deltas
    straddle a floor() boundary, which moves an element by up to one
    quantum (the leaf's scale/qmax; the largest |residual| of the leaf
    stands for it). So per leaf: every element within 1e-4 plus two
    quanta, and at most one element in 10^4 beyond 1e-4 after the first
    round, one in 10^3 after the second (the first round's flips move
    the second round's gradients: measured 5.5e-4 of the embedding);
  * int8 codes: one round from the same (carried-over) replicas. Each
    leaf's new residuals must agree within a tenth of the leaf's largest
    residual — a flipped code moves a residual by a whole quantum
    (scale/qmax), which is at least that largest residual; float32
    rounding moves it by ~1e-7 of the scale — and the consensus within
    1e-6;
  * microbatch / SyncSGD / pod-client steps: 1e-5;
  * the semantics tests of ``tests/test_local_sgd_semantics.py`` and
    the flat-rail checks of ``tests/test_hierarchical_driver.py`` with
    their own tolerances (bit-equality where the reference asks for it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import local_sgd as JLS
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import get_arch
from repro_torch.core import local_sgd as TLS
from repro_torch.utils.convert import train_state_from_jax
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

C, B, S, K, ETA = 2, 2, 32, 2, 0.05


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    tcfg = get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    states = {n: JLS.init_state(jax.random.key(0), jcfg, n) for n in (2, 4)}
    mesh = make_host_mesh(1, 1)
    steps = {n: jax.jit(JLS.build_train_steps(jcfg, mesh)[0]) for n in (2, 4)}
    return jcfg, tcfg, states, steps


def _batches(cfg, n, count, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        toks = rng.randint(0, cfg.vocab_size, (n, B, S + 1))
        out.append({"tokens": toks[..., :-1].astype(np.int32),
                    "labels": toks[..., 1:].astype(np.int32)})
    return out


def _jb(b):
    return jax.tree.map(jnp.asarray, b)


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _port_state(jstate):
    return train_state_from_jax(to_numpy_tree(jstate), "cpu")


def _close(port_tree, jax_tree, tol):
    got = tree_flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=tol, rtol=tol, err_msg=path)


def _blocks(comm, key):
    """The trees under ``key`` ("ref" / "res") of a flat or two-level comm
    state, in order; each has the params' structure."""
    if isinstance(comm, dict) and key in comm:
        return [comm[key]]
    if isinstance(comm, dict):
        return [t for k in sorted(comm) for t in _blocks(comm[k], key)]
    if isinstance(comm, (tuple, list)):
        return [t for c in comm for t in _blocks(c, key)]
    return []


def _quanta(jcomm):
    """Per leaf, the largest |residual| over every client, pod and hop: up
    to one int8 quantum of that leaf."""
    res = [jax.tree.leaves(t) for t in _blocks(jcomm, "res")]
    return [max(float(np.abs(np.asarray(t[i])).max()) for t in res)
            for i in range(len(res[0]))]


def _close_int8(port_tree, jax_tree, quanta, frac):
    got = tree_flatten_with_path(port_tree)[0]
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want) == len(quanta)
    for (path, a), b, q in zip(got, want, quanta):
        d = np.abs(a.detach().numpy() - np.asarray(b))
        assert d.max() <= 1e-4 + 2 * q, (path, d.max(), q)
        assert (d > 1e-4).mean() <= frac, (path, (d > 1e-4).sum())


def _run_jax(step, sync, state, batches):
    for b in batches:
        state, _ = step(state, _jb(b), ETA)
    return sync(state)


def _run_port(step, sync, state, batches):
    for b in batches:
        state, _ = step(state, _tb(b), ETA)
    return sync(state)


ROUNDS = {  # (intra reducer, streaming, two-level inter reducer)
    "dense": ("dense", False, None),
    "streaming": ("dense", True, None),
    "int8": ("int8", False, None),
    "int8-streaming": ("int8", True, None),
    "hier dense+int8": ("dense", False, "int8"),
    "hier int8+int8": ("int8", False, "int8"),
}


def _jax_sync(intra, streaming, inter):
    """Eager, as the port computes: under jit XLA rewrites q·(s/qmax) as
    q·(s·(1/qmax)) (ROADMAP §3), an ulp off the source's arithmetic."""
    if inter is None:
        return JLS.build_sync_step(intra, streaming=streaming)
    return JLS.build_sync_step(intra, hierarchical=True, n_pods=2,
                               inter_reducer=inter)


def _port_steps(tcfg, intra, streaming, inter, **kw):
    axis = ("pod", "data") if inter else "data"
    return TLS.build_train_steps(tcfg, "cpu", client_axis=axis,
                                 reducer=intra, streaming=streaming,
                                 inter_reducer=inter, n_pods=2,
                                 rng=JaxKey(jax.random.key(0)), **kw)


@pytest.mark.parametrize("case", list(ROUNDS))
def test_rounds_match_jax(setup, case):
    """Two rounds of K local steps and a sync; the error-feedback state
    rides in ``comm`` across them."""
    jcfg, tcfg, states, steps = setup
    intra, streaming, inter = ROUNDS[case]
    n = 4 if inter else C
    jsync = _jax_sync(intra, streaming, inter)
    tstep, tsync, _ = _port_steps(tcfg, intra, streaming, inter)
    assert (tsync.reducer.name, tsync.streaming, tsync.hierarchical) == \
        (jsync.reducer.name, jsync.streaming, jsync.hierarchical)
    js, ts = states[n], _port_state(states[n])
    batches = _batches(jcfg, n, 2 * K)
    for r in range(2):
        js = _run_jax(steps[n], jsync, js, batches[r * K:(r + 1) * K])
        ts = _run_port(tstep, tsync, ts, batches[r * K:(r + 1) * K])
        assert ts["step"] == int(js["step"]) == (r + 1) * K
        assert set(ts) == set(js)
        if "comm" not in js:
            _close(ts["params"], js["params"], 1e-5)
            _close(ts["opt"], js["opt"], 1e-5)
            continue
        q, frac = _quanta(js["comm"]), (1e-4, 1e-3)[r]
        for key in ("ref", "res"):
            for a, b in zip(_blocks(ts["comm"], key),
                            _blocks(js["comm"], key)):
                _close_int8(a, b, q, frac)
        _close_int8(ts["params"], js["params"], q, frac)
        _close_int8(ts["opt"], js["opt"], q, frac)


@pytest.mark.parametrize("case", [c for c in ROUNDS if "int8" in c])
def test_int8_codes_equal_on_the_same_replicas(setup, case):
    """One int8 round from replicas carried over from JAX (so both reduce
    the same inputs with the same bits): equal codes."""
    jcfg, tcfg, states, steps = setup
    intra, streaming, inter = ROUNDS[case]
    n = 4 if inter else C
    js = states[n]
    for b in _batches(jcfg, n, K, seed=1):
        js, _ = steps[n](js, _jb(b), ETA)
    ts = _port_state(js)
    _, tsync, _ = _port_steps(tcfg, intra, streaming, inter)
    js, ts = _jax_sync(intra, streaming, inter)(js), tsync(ts)
    _close(ts["params"], js["params"], 1e-6)
    got, want = _blocks(ts["comm"], "res"), _blocks(js["comm"], "res")
    assert len(got) == len(want) > 0
    for tree_a, tree_b in zip(got, want):
        for a, b in zip(tree_leaves(tree_a), jax.tree.leaves(tree_b)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 0.1 * np.abs(b).max()


STEP_MODES = {
    "microbatch": dict(microbatch=2),
    "sync_grads": dict(sync_grads=True),
    "pod": dict(client_axis="pod"),
}


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_step_modes_match_jax(setup, mode):
    jcfg, tcfg, states, _ = setup
    kw = STEP_MODES[mode]
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1),
                                          **kw)[0])
    tstep = TLS.build_train_steps(tcfg, "cpu", **kw)[0]
    b = _batches(jcfg, C, 1, seed=2)[0]
    if mode == "pod":   # (C, data shards, per shard, S)
        b = {k: v.reshape(C, 2, 1, S) for k, v in b.items()}
    js, jm = jstep(states[C], _jb(b), ETA)
    ts, tm = tstep(_port_state(states[C]), _tb(b), ETA)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _close(ts["params"], js["params"], 1e-5)
    _close(ts["opt"], js["opt"], 1e-5)


def test_per_client_step_updates_one_replica(setup):
    jcfg, tcfg, states, _ = setup
    ts = _port_state(states[C])
    before = [t.clone() for t in tree_leaves(ts["params"])]
    _, _, per_client = TLS.build_train_steps(tcfg, "cpu")
    rows = lambda tree, c: jax.tree.map(lambda x: x[c], tree)
    b = _tb(_batches(jcfg, C, 1, seed=3)[0])
    _, _, loss = per_client(rows(ts["params"], 1), rows(ts["opt"], 1),
                            rows(b, 1), ETA)
    assert loss.shape == () and float(loss) > 0
    for x, y in zip(tree_leaves(ts["params"]), before):
        assert torch.equal(x[0], y[0]) and not torch.equal(x[1], y[1])


# ---------------------------------------------------------------------------
# Algorithm-1 semantics (the reference's tests/test_local_sgd_semantics.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four(setup):
    jcfg, tcfg, states, _ = setup
    b = _tb(_batches(jcfg, 4, 1, seed=4)[0])
    return tcfg, states[4], b


def test_k1_local_equals_syncsgd(four):
    tcfg, jstate, batch = four
    local_step, sync_step, _ = TLS.build_train_steps(tcfg, "cpu")
    syncsgd_step, _, _ = TLS.build_train_steps(tcfg, "cpu", sync_grads=True)
    s_local, _ = local_step(_port_state(jstate), batch, ETA)
    s_local = sync_step(s_local)
    s_sync, _ = syncsgd_step(_port_state(jstate), batch, ETA)
    for a, b in zip(tree_leaves(s_local["params"]),
                    tree_leaves(s_sync["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6)


def test_local_step_client_independence(four):
    tcfg, jstate, batch = four
    local_step, _, _ = TLS.build_train_steps(tcfg, "cpu")
    s1, _ = local_step(_port_state(jstate), batch, ETA)
    batch2 = {k: v.clone() for k, v in batch.items()}
    batch2["tokens"][3] = (batch2["tokens"][3] + 7) % tcfg.vocab_size
    s2, _ = local_step(_port_state(jstate), batch2, ETA)
    pairs = list(zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])))
    for a, b in pairs:
        assert torch.equal(a[:3], b[:3])
    assert any(not torch.equal(a[3], b[3]) for a, b in pairs)


def test_sync_step_is_replica_mean(four):
    tcfg, jstate, batch = four
    local_step, sync_step, _ = TLS.build_train_steps(tcfg, "cpu")
    s, _ = local_step(_port_state(jstate), batch, ETA)
    mean = [x.mean(0) for x in tree_leaves(s["params"])]
    s2 = sync_step(s)
    for m, leaf in zip(mean, tree_leaves(s2["params"])):
        for i in range(leaf.shape[0]):
            np.testing.assert_allclose(leaf[i].numpy(), m.numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_microbatch_grad_equivalence(four):
    tcfg, jstate, batch = four
    s_full, m_full = TLS.build_train_steps(tcfg, "cpu", microbatch=1)[0](
        _port_state(jstate), batch, ETA)
    s_mb, m_mb = TLS.build_train_steps(tcfg, "cpu", microbatch=2)[0](
        _port_state(jstate), batch, ETA)
    assert float(m_full["loss"]) == pytest.approx(float(m_mb["loss"]),
                                                  rel=1e-4)
    for a, b in zip(tree_leaves(s_full["params"]),
                    tree_leaves(s_mb["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The flat rail of the two-level round (tests/test_hierarchical_driver.py)
# ---------------------------------------------------------------------------

def _diverged(four):
    tcfg, jstate, batch = four
    s, _ = TLS.build_train_steps(tcfg, "cpu")[0](_port_state(jstate), batch,
                                                 ETA)
    return s


def _equal_states(a, b):
    assert set(a) == set(b)
    for x, y in zip(tree_leaves(a["params"]) + tree_leaves(a["opt"]),
                    tree_leaves(b["params"]) + tree_leaves(b["opt"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hier", [
    dict(n_pods=2, inter_reducer="dense"),
    dict(n_pods=1, inter_reducer="int8")])
def test_two_level_flat_cases_bit_equal_flat_round(four, hier):
    """dense∘dense over 2 pods and any round over one pod give the flat
    dense round bit for bit, with no comm state."""
    flat = TLS.build_sync_step(None)(_diverged(four))
    two = TLS.build_sync_step(None, hierarchical=True, **hier)(
        _diverged(four))
    _equal_states(flat, two)
    assert "comm" not in two
    assert TLS.build_sync_step(None, hierarchical=True, n_pods=1) \
        .hierarchical is False


def test_two_level_rejects_indivisible_clients(setup):
    jcfg, tcfg, _, _ = setup
    state = TLS.init_state(0, tcfg, 5, device="cpu")
    sync = TLS.build_sync_step(None, hierarchical=True, n_pods=2)
    with pytest.raises(ValueError, match="divisible"):
        sync(state)


def test_two_level_needs_a_pod_axis(setup):
    _, tcfg, _, _ = setup
    with pytest.raises(ValueError, match="pod"):
        TLS.build_train_steps(tcfg, "cpu", client_axis="data",
                              inter_reducer="int8")


def test_mesh_functions_name_their_roadmap_item(setup):
    """The mesh functions that raised before the mesh was ported now give
    the reference's answers (state_shardings on a mesh: the mesh tests)."""
    jcfg, tcfg, _, _ = setup
    for ca, extra in (("data", False), (("pod", "data"), False),
                      ("pod", True), (None, False)):
        got = TLS.batch_spec(tcfg, ca, extra)
        want = JLS.batch_spec(jcfg, ca, extra)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k]) == tuple(want[k]), (ca, k)
    shape = TLS.init_state_shape(tcfg, 2)
    real = TLS.init_state(0, tcfg, 2, device="cpu")
    got = tree_flatten_with_path(shape)[0]
    want = tree_flatten_with_path(real)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        if isinstance(b, torch.Tensor):
            assert a.device.type == "meta" and a.shape == b.shape \
                and a.dtype == b.dtype, p


def test_step_refuses_a_state_on_another_device(setup):
    _, tcfg, _, _ = setup
    step = TLS.build_train_steps(tcfg, "cpu")[0]
    state = TLS.init_state(0, tcfg, 2, device="cpu")
    state["params"]["embed"] = state["params"]["embed"].to("meta")
    with pytest.raises(ValueError, match="state on meta"):
        step(state, {}, ETA)


# ---------------------------------------------------------------------------
# bf16 parameters with a float32 gradient (the microbatch accumulator)
# ---------------------------------------------------------------------------

def test_sgd_update_adds_a_float32_gradient_in_float32():
    """bf16 parameters, float32 moments and a float32 gradient, as the
    microbatch step hands them: the port's ``sgd_update`` against the
    reference's on the same numpy inputs. m' within 1e-6 relative (float32
    rounding; a gradient rounded to bf16 first is off by up to 2^-9) and
    p' within one bf16 step of |p|."""
    from repro.optim.sgd import sgd_update as j_update
    from repro_torch.optim.sgd import sgd_update as t_update

    rng = np.random.RandomState(6)
    shapes = {"a": (3, 257), "b": (64,)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    m = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.randn(*s) * np.exp(rng.randn(*s))).astype(np.float32)
         for k, s in shapes.items()}
    jp, js = j_update({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                      {k: jnp.asarray(v) for k, v in g.items()},
                      {"mu": {k: jnp.asarray(v) for k, v in m.items()}},
                      eta=0.1, momentum=0.9, weight_decay=1e-4)
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16)
          for k, v in p.items()}
    ts = {"mu": {k: torch.from_numpy(v.copy()) for k, v in m.items()}}
    t_update(tp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts,
             eta=0.1, momentum=0.9, weight_decay=1e-4)
    for k in shapes:
        np.testing.assert_allclose(ts["mu"][k].numpy(),
                                   np.asarray(js["mu"][k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        want = np.asarray(jp[k], np.float32)
        np.testing.assert_allclose(tp[k].float().numpy(), want,
                                   rtol=2.0 ** -8, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def bf16_pair(setup):
    jcfg = setup[0].replace(dtype="bfloat16")
    tcfg = setup[1].replace(dtype="bfloat16")
    return jcfg, tcfg, JLS.init_state(jax.random.key(0), jcfg, C)


def test_bf16_microbatch_step_matches_jax(bf16_pair):
    """qwen3 SMOKE in bf16, ``microbatch=2``: the float32 accumulated
    gradient reaches the update unrounded on both sides. bf16 products
    round differently in the two packages, so each leaf's moment is held
    to 2e-2 of its norm; each parameter, p' = bf16(p − η·m'), to η times
    its moments' difference plus one bf16 step of the larger |p'| (each
    side rounds once, by half a step at most; and XLA's FMA)."""
    jcfg, tcfg, jstate = bf16_pair
    jstep = jax.jit(JLS.build_train_steps(jcfg, make_host_mesh(1, 1),
                                          microbatch=2)[0])
    tstep = TLS.build_train_steps(tcfg, "cpu", microbatch=2)[0]
    b = _batches(jcfg, C, 1, seed=2)[0]
    js, jm = jstep(jstate, _jb(b), ETA)
    ts, tm = tstep(_port_state(jstate), _tb(b), ETA)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)
    for a, w, mt, mj in zip(tree_leaves(ts["params"]),
                            jax.tree.leaves(js["params"]),
                            tree_leaves(ts["opt"]),
                            jax.tree.leaves(js["opt"])):
        assert mt.dtype == torch.float32
        mt, mj = mt.numpy(), np.asarray(mj)
        assert np.linalg.norm(mt - mj) <= 2e-2 * np.linalg.norm(mj)
        w = np.asarray(w, np.float32)
        a = a.float().numpy()
        d = np.abs(a - w)
        step = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(w))
        # XLA fuses p − η·m into an FMA: the product unrounded, a float32
        # rounding of η·m (2^-24 of it) off where p' is near 0
        fma = 2.0 ** -23 * ETA * np.abs(mj)
        assert (d <= step + ETA * 1.001 * np.abs(mt - mj) + fma).all(), \
            d.max()
