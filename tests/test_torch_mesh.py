"""The port's mesh route against the JAX package's sharded training.

``tests/mesh_cases.py`` runs one table of cases three ways: the JAX
package's ``build_train_steps`` jitted with ``in_shardings`` on 4 host
devices (a subprocess; its int8 rounds eager on the sharded arrays, since
under jit XLA rewrites q·(s/qmax) an ulp off), the port's
``build_train_steps(cfg, mesh)`` on 4 ``gloo`` processes (spawned once for
the module), and the port's single-device route. qwen3-14b and
mamba2-2.7b SMOKE in float32 on a (data=2, model=2) mesh: K = 2 local
steps, then a dense and an int8 round; qwen3 on a (pod=2, data=2,
model=1) mesh: the two-level round (dense over data, int8 over pod) and
pod-client mode (``client_axis="pod"``, FSDP on data); qwen3 on a
(data=1, model=4) mesh (2 KV heads on 4 ranks: k and v replicated, each
rank taking its q head's KV head; both clients on every rank) and a
dense round. Tolerances:

  * local steps and dense rounds: 1e-5 (float32 products split over
    ranks and summed in another order);
  * an int8 round after the local steps: each element within 1e-4 plus
    two quanta, at most one in 10^4 beyond 1e-4 (a code may flip where
    the two runs' deltas straddle a floor() boundary, as in
    ``tests/test_torch_local_sgd.py``);
  * an int8 round from the same replicas (a noisy start both runs are
    given): equal codes — each leaf's residuals within a tenth of its
    largest residual (a flipped code moves one by a whole quantum), the
    consensus within 1e-6;
  * a one-rank mesh: bit-equal to the device route;
  * a dense round of distinct bfloat16 replicas on a (data=4, model=1)
    mesh: equal to the reference's and to the device route's (a float32
    sum rounded once);
  * serving on the (data=2, model=2) mesh (``serve_shardings``: rows over
    data or, for one row, the cache's sequence over data; heads on
    model), from the reference's float32 params: a prefill's and three
    decode steps' logits within 1e-5 of the reference's, jitted with the
    same shardings on 4 host devices, and of the device route's.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mesh_cases as MC
from jax_replay import one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import local_sgd as JLS
from repro.models import transformer as JTF

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

ROUND_CASES = [(c, r[0]) for c in MC.CASES for r in MC.rounds_of(c)]


def _noisy(state, seed):
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, state)
    out["params"] = jax.tree.map(
        lambda x: (x + rng.normal(0, 1e-2, x.shape)).astype(x.dtype),
        out["params"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    inp = {}
    for i, (case, (arch, _, _, _, n)) in enumerate(MC.CASES.items()):
        cfg = jax_get_arch(arch, smoke=True).replace(dtype="float32")
        init = to_numpy_tree(JLS.init_state(jax.random.key(0), cfg, n))
        inp[case] = {"init": init, "noise": _noisy(init, 10 + i)}
    arch, _, _, _, n = MC.BF16_CASE
    init = to_numpy_tree(JLS.init_state(jax.random.key(0),
                                        jax_get_arch(arch, smoke=True), n))
    inp["bf16"] = _noisy(init, 20)
    inp["serving"] = {
        arch: to_numpy_tree(JTF.init_params(
            jax.random.key(1), jax_get_arch(arch, smoke=True)
            .replace(dtype="float32")))
        for arch in {a for a, _, _ in MC.SERVE_CASES.values()}}
    inp_path = os.path.join(tmp, "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    ref_path, port_path = (os.path.join(tmp, n)
                           for n in ("ref.pkl", "port.pkl"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", MC.reference_script(SRC, HERE), inp_path,
         ref_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        MC.spawn_port(inp_path, port_path, tmp)
        device = MC.run_port_cases(inp_path, device_route=True)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with open(ref_path, "rb") as f:
        reference = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    device["serving"] = MC.run_serving_cases(inp_path, device_route=True)
    return reference, port, device


def _keys(a, b):
    assert sorted(a) == sorted(b)
    return sorted(a)


def _close(got, want, tol, what):
    for part in _keys(got, want):
        for p in _keys(got[part], want[part]):
            np.testing.assert_allclose(got[part][p], want[part][p],
                                       atol=tol, rtol=tol,
                                       err_msg=f"{what} {part} {p}")


def _residual_quanta(st):
    """Per leaf path, the largest |residual| over every client and hop."""
    q = {}
    for p, x in st["comm"].items():
        if "['res']" in p:
            leaf = p.split("['res']")[1]
            q[leaf] = max(q.get(leaf, 0.0), float(np.abs(x).max()))
    return q


def _quantum(q, path):
    return max((v for k, v in q.items() if path.endswith(k)), default=0.0)


@pytest.mark.parametrize("case", list(MC.CASES))
def test_mesh_local_steps_match_the_reference(runs, case):
    reference, port, device = runs
    _close(port[case]["local"], reference[case]["local"], 1e-5,
           f"{case} mesh vs JAX")
    _close(port[case]["local"], device[case]["local"], 1e-5,
           f"{case} mesh vs device route")


def _topk_near_cut(local, frac=0.1, tol=1e-5):
    """Per leaf path, where the reference's first top-k round from
    ``local`` (ref = client 0's params, no residual: y = x - x[0]) meets
    elements within ``tol`` of their row's k-th largest magnitude."""
    near = {}
    for path, x in local["params"].items():
        a = np.abs(x - x[:1]).reshape(x.shape[0], -1)
        k = max(1, min(a.shape[1], int(round(frac * a.shape[1]))))
        t = -np.sort(-a, axis=1)[:, k - 1:k]
        near[path] = (np.abs(a - t) <= tol).reshape(x.shape)
    return near


def _check_topk_round(got, want, near, what):
    """A top-k round after the local steps: within 1e-5, except at
    elements one run keeps and the other drops, which lie within 1e-5 of
    their row's k-th largest magnitude — at most one in 10^4 of a leaf."""
    for part in _keys(got, want):
        for p in _keys(got[part], want[part]):
            bad = np.abs(got[part][p] - want[part][p]) > 1e-5
            if not bad.any():
                continue
            assert bad.mean() <= 1e-4, (what, part, p, bad.mean())
            leaf = next(k for k in near if p.endswith(k))
            flips = near[leaf] if bad.shape == near[leaf].shape else \
                near[leaf].any(axis=0)
            assert flips[bad].all(), (what, part, p)


def _check_topk_noise(got, want, what):
    """A top-k round from the same replicas: the same kept elements, so
    residuals exactly equal, the consensus within 1e-6."""
    for part in _keys(got, want):
        for p in _keys(got[part], want[part]):
            tol = 0.0 if "['res']" in p else 1e-6
            d = np.abs(got[part][p] - want[part][p])
            assert d.max() <= tol, (what, part, p, d.max())


@pytest.mark.parametrize("case,name", ROUND_CASES)
def test_mesh_rounds_match_the_reference(runs, case, name):
    reference, port, device = runs
    got, want, dev = (r[case][name] for r in (port, reference, device))
    assert sorted(got) == sorted(want)
    if "comm" not in want:   # dense rounds
        _close(got, want, 1e-5, f"{case} {name} mesh vs JAX")
        _close(got, dev, 1e-5, f"{case} {name} mesh vs device route")
        return
    if "topk" in name:
        if name.endswith("noise"):
            _check_topk_noise(got, want, f"{case} {name} mesh vs JAX")
            _check_topk_noise(got, dev, f"{case} {name} mesh vs device")
        else:
            near = _topk_near_cut(reference[case]["local"])
            _check_topk_round(got, want, near, f"{case} {name} mesh vs JAX")
            _check_topk_round(got, dev, near, f"{case} {name} mesh vs device")
        return
    q = _residual_quanta(want)
    for part in _keys(got, want):
        for p in _keys(got[part], want[part]):
            d = np.abs(got[part][p] - want[part][p])
            if name.endswith("noise"):
                # the same replicas and bits: equal codes
                tol = (0.1 * _quantum(q, p) if "['res']" in p else 1e-6)
                assert d.max() <= max(tol, 1e-6), (case, name, p, d.max())
            else:
                qq = _quantum(q, p)
                assert d.max() <= 1e-4 + 2 * qq, (case, name, p, d.max())
                assert (d > 1e-4).mean() <= 1e-4, (case, name, p)
    if name.endswith("noise"):
        for part in _keys(got, dev):
            for p in _keys(got[part], dev[part]):
                d = np.abs(got[part][p] - dev[part][p])
                tol = (0.1 * _quantum(q, p) if "['res']" in p else 1e-6)
                assert d.max() <= max(tol, 1e-6), (case, name, p, d.max())


def test_int8_rounds_quantize_something(runs):
    """The noisy start's round leaves residuals (codes were drawn)."""
    reference, _, _ = runs
    q = _residual_quanta(reference["dm-qwen3"]["int8-noise"])
    assert min(q.values()) > 0


@pytest.mark.parametrize("case", sorted(MC.STREAMING_ROUNDS))
def test_mesh_streaming_round_equals_the_blocking_one(runs, case):
    """The port's streaming round (leaf by leaf, reverse-layer order) on
    the mesh, and on one device, equals its blocking round bit for bit."""
    _, port, device = runs
    name = MC.STREAMING_ROUNDS[case]
    for run in (port, device):
        got, want = run[case][name + "-streaming"], run[case][name]
        for part in _keys(got, want):
            for p in _keys(got[part], want[part]):
                np.testing.assert_array_equal(got[part][p], want[part][p],
                                              err_msg=f"{case} {part} {p}")


def test_mesh_state_gathered_and_placed_again_rounds_the_same(runs):
    """``gather_state`` then ``place_state`` gives back what the mesh
    round keeps (the two-level round's per-pod intra state included): a
    round from it equals a round from the kept state bit for bit."""
    _, port, _ = runs
    case, name = MC.REPLACED_ROUND
    got, want = port[case][name + "-replaced"], port[case][name + "-again"]
    assert "comm" in want
    assert any("['intra'][1]" in p for p in want["comm"])
    for part in _keys(got, want):
        for p in _keys(got[part], want[part]):
            np.testing.assert_array_equal(got[part][p], want[part][p],
                                          err_msg=f"{part} {p}")


@pytest.mark.parametrize("frac", MC.TIE_FRACS)
def test_topk_ties_across_the_model_split_keep_the_reference_indices(
        runs, frac):
    """``TopKMean.reduce`` of a tree whose tied magnitudes straddle the
    ``model`` split (each leaf's dim over 2 ranks, clients over data)
    keeps what ``jax.lax.top_k`` keeps: the consensus and residuals of
    the reference's reduce on the whole tree, exactly."""
    from repro.comm import TopKMean as JTopK

    _, port, _ = runs
    tree = {n: x for n, (x, _) in MC.tie_tree().items()}
    zero = {"ref": {n: np.zeros(x.shape[1:], np.float32)
                    for n, x in tree.items()},
            "res": {n: np.zeros_like(x) for n, x in tree.items()}}
    cons, st = JTopK(frac=frac).reduce(jax.tree.map(jax.numpy.asarray, tree),
                                       jax.tree.map(jax.numpy.asarray, zero),
                                       jax.random.key(0))
    got = port["ties"][frac]
    for n in tree:
        np.testing.assert_array_equal(got["consensus"][n],
                                      np.asarray(cons[n]), err_msg=n)
        np.testing.assert_array_equal(got["res"][n], np.asarray(st["res"][n]),
                                      err_msg=n)
        kept = (got["res"][n] == 0) & (tree[n] != 0)
        assert kept.any() and not kept.all()


def test_one_rank_mesh_is_bit_equal_to_the_device_route():
    import torch.distributed as dist

    from jax_replay import JaxKey
    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd as TLS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.tree import tree_flatten_with_path

    cfg = get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        for reducer in ("int8", "topk"):
            outs = []
            for where in ("cpu", mesh):
                state = TLS.init_state(0, cfg, 2, device="cpu")
                if where is mesh:
                    state = TLS.place_state(state, mesh)
                local, sync, _ = TLS.build_train_steps(
                    cfg, where, reducer=reducer,
                    rng=JaxKey(jax.random.key(0)))
                for b in MC.batches(cfg.vocab_size, "dm-qwen3"):
                    b = {k: torch.from_numpy(v).long() for k, v in b.items()}
                    state, m = local(state, b, MC.ETA)
                state = sync(state)
                state = TLS.gather_state(state)
                outs.append(([x for _, x in tree_flatten_with_path(
                    {k: v for k, v in state.items() if k != "step"})[0]],
                    m["loss"]))
            (a, la), (b, lb) = outs
            assert len(a) == len(b) > 0
            assert all(torch.equal(x, y) for x, y in zip(a, b)), reducer
            assert torch.equal(la, lb)
    finally:
        dist.destroy_process_group()


def _bf16_ulps(got, want):
    """|got − want| in units of want's bfloat16 ulp (float32 arrays that
    hold bfloat16 values)."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


def test_bf16_dense_round_rounds_once(runs):
    """Distinct bfloat16 replicas, one a rank on a (data=4, model=1) mesh:
    the consensus is the float32 sum over all ranks divided by 4 and
    rounded once to bfloat16, as the reference's jnp.mean and the device
    route's torch.mean make it — equal to both, element for element."""
    reference, port, device = runs
    for want, what in ((reference["bf16"], "JAX"),
                       (device["bf16"], "device route")):
        for part in _keys(port["bf16"], want):
            for p in _keys(port["bf16"][part], want[part]):
                got, ref = port["bf16"][part][p], want[part][p]
                assert got.shape == ref.shape
                assert _bf16_ulps(got, ref).max() == 0, (what, part, p)


@pytest.mark.parametrize("case", list(MC.SERVE_CASES))
def test_serving_on_the_mesh_matches_the_reference(runs, case):
    """The reference's prefill and decode steps jitted with the same
    shardings (rows or the cache's sequence over data, heads on model) on
    4 host devices, from the same params and tokens."""
    reference, port, _ = runs
    got, want = port["serving"][case], reference["serving"][case]
    assert len(got) == len(want) == 1 + MC.DECODE_STEPS
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{case} call {i}")


@pytest.mark.parametrize("case", list(MC.SERVE_CASES))
def test_serving_on_the_mesh_matches_the_device_route(runs, case):
    _, port, device = runs
    got, want = port["serving"][case], device["serving"][case]
    assert len(got) == len(want) == 1 + MC.DECODE_STEPS
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{case} call {i}")
