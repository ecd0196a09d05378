"""The port's kernel modules against the JAX package's kernels.

On the CPU each port wrapper takes its plain PyTorch version (the tensor's
device picks the route). The same numpy inputs go through the JAX kernel
(Pallas in interpret mode, and the jnp oracle ``impl="xla"``) and the
port. Tolerances: fused update 1e-6 in float32 and 1e-2 in bfloat16 (the
JAX kernel tests' own); quantize codes exactly equal; dequant_mean 1e-6
(the two sum N terms in possibly different orders); the dequantized
messages exactly equal. ``test_torch_gpu.py`` holds the CUDA kernels
against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import bits_i32
from quant_cases import EDGE_CASES, edge_inputs, random_inputs
from repro.kernels.fused_update.ops import sgd_update as j_sgd_update
from repro.kernels.quantize import ops as JQ
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.fused_update import ops as TF
from repro_torch.kernels.fused_update.kernel import (fused_sgd_update,
                                                     fused_sgd_update_leaves)
from repro_torch.kernels.fused_update.ref import (sgd_update_ref,
                                                  tree_sgd_update_ref)
from repro_torch.kernels.quantize import ops as TQ
from repro_torch.kernels.quantize import ref as TQR
from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)
from repro_torch.kernels.ssd import kernel as SSD

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pmg(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32),
            rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("beta,wd", [(0.0, 0.0), (0.9, 0.0), (0.0, 1e-4),
                                     (0.9, 1e-4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 70001])
def test_fused_update_matches_jax(n, dtype, beta, wd, impl):
    jdt, tdt = _DT[dtype]
    p, m, g = _pmg(n)
    pj, mj = j_sgd_update(jnp.asarray(p).astype(jdt), jnp.asarray(m),
                          jnp.asarray(g).astype(jdt), eta=0.1, beta=beta,
                          wd=wd, impl=impl)
    # the port updates in place: it gets its own copies, since JAX may read
    # the numpy buffers (zero-copy, asynchronously) after this point
    pt = torch.from_numpy(p.copy()).to(tdt)
    mt = torch.from_numpy(m.copy())
    gt = torch.from_numpy(g.copy()).to(tdt)
    TF.sgd_update_(pt, mt, gt, eta=0.1, beta=beta, wd=wd)   # in place
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(pt.float().numpy(),
                               np.asarray(pj, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj, np.float32),
                               atol=tol, rtol=tol)


def test_fused_update_tree_in_place_and_ref_pure():
    params = {"b": torch.full((256,), 2.0), "a": torch.ones((37, 5))}
    moms = {"a": torch.zeros((37, 5)), "b": torch.zeros((256,))}
    grads = {"a": torch.full((37, 5), 0.5), "b": torch.ones((256,))}
    p_before = params["a"].clone()
    p2, m2 = sgd_update_ref(params["a"], moms["a"], grads["a"], eta=0.1)
    assert torch.equal(params["a"], p_before)          # ref is pure
    out_p, _ = TF.tree_sgd_update_(params, moms, grads, eta=0.1)
    assert out_p is params                             # wrapper is in place
    torch.testing.assert_close(params["a"], p2, rtol=0, atol=0)
    torch.testing.assert_close(moms["a"], m2, rtol=0, atol=0)
    torch.testing.assert_close(params["b"], torch.full((256,), 1.9))


@pytest.mark.parametrize("p_dtype, m_dtype", [("float32", "float32"),
                                              ("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
def test_tree_update_equals_jax_leaf_by_leaf(p_dtype, m_dtype):
    """The MLP's 8 leaves (lengths 1 to 75,264, some not a multiple of 4)
    stacked over 3 clients: the tree route (on the CPU the plain
    ``tree_sgd_update_ref``) against JAX's update of each leaf."""
    lengths = [96, 784 * 96, 96, 96 * 96, 96, 96 * 96, 1, 96]
    jp, jm = _DT[p_dtype][0], _DT[m_dtype][0]
    tp, tm = _DT[p_dtype][1], _DT[m_dtype][1]
    trees = {"p": [], "m": [], "g": []}
    want = []
    for i, n in enumerate(lengths):
        p, m, g = (a.reshape(1, n).repeat(3, 0) * (1 + np.arange(3))[:, None]
                   for a in _pmg(n, seed=i))
        pj, mj = j_sgd_update(jnp.asarray(p).astype(jp),
                              jnp.asarray(m).astype(jm),
                              jnp.asarray(g).astype(jp), eta=0.1, beta=0.9,
                              wd=1e-4, impl="xla")
        want.append((np.asarray(pj, np.float32), np.asarray(mj, np.float32)))
        for k, a, dt in (("p", p, tp), ("m", m, tm), ("g", g, tp)):
            trees[k].append(torch.from_numpy(a.copy()).to(dt))
    ref_p, ref_m = tree_sgd_update_ref(trees["p"], trees["m"], trees["g"],
                                       eta=0.1, beta=0.9, wd=1e-4)
    TF.tree_sgd_update_(trees["p"], trees["m"], trees["g"], eta=0.1,
                        beta=0.9, wd=1e-4)
    for (pj, mj), pt, mt, pr, mr in zip(want, trees["p"], trees["m"], ref_p,
                                        ref_m):
        assert torch.equal(pt, pr) and torch.equal(mt, mr)
        tol = 1e-6 if p_dtype == m_dtype == "float32" else 1e-2
        np.testing.assert_allclose(pt.float().numpy(), pj, atol=tol, rtol=tol)
        np.testing.assert_allclose(mt.float().numpy(), mj, atol=tol, rtol=tol)


def test_multi_leaf_launcher_refuses_before_any_launch():
    """Every leaf is checked before anything launches: CPU leaves, lists
    of unequal length, and a tree whose leaves sit on two devices raise
    and count nothing."""
    K.reset_launch_counts()
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_sgd_update_leaves([x], [x.clone()], [x.clone()], eta=0.1)
    with pytest.raises(ValueError):
        fused_sgd_update_leaves([x, x], [x], [x], eta=0.1)
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no route"):
        TF.tree_sgd_update_([x, meta], [x.clone(), meta], [x.clone(), meta],
                            eta=0.1)
    assert fused_sgd_update.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "g_dtype", "shape",
                                 "noncontiguous"])
def test_fused_update_rejects_bad_inputs(bad):
    p, m, g = (torch.zeros(8, 4) for _ in range(3))
    if bad == "dtype":
        p, m, g = p.double(), m.double(), g.double()
    elif bad == "g_dtype":
        g = g.to(torch.bfloat16)
    elif bad == "shape":
        g = torch.zeros(8, 5)
    else:
        p = torch.zeros(4, 8).t()
    with pytest.raises((TypeError, ValueError)):
        TF.sgd_update_(p, m, g, eta=0.1)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA wrappers never run on the CPU: they raise before any
    launch (and before building anything), and their counts stay put."""
    K.reset_launch_counts()
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_sgd_update(x, x.clone(), x.clone(), eta=0.1)
    with pytest.raises(ValueError):
        quantize_kernel(x, torch.zeros(4, 8, dtype=torch.int32),
                        torch.ones(4))
    with pytest.raises(ValueError):
        dequant_mean_kernel(torch.zeros(4, 8, dtype=torch.int8),
                            torch.ones(4))
    with pytest.raises(ValueError):
        FA.flash_attention(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64),
                           torch.zeros(1, 8, 2, 64))
    with pytest.raises(ValueError):
        SSD.ssd(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2),
                torch.zeros(2), torch.zeros(1, 8, 1, 16),
                torch.zeros(1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_bwd(*_ssd_bwd_args())
    assert K.launch_counts() == {"fused_sgd_update": 0, "quantize_kernel": 0,
                                 "dequant_mean_kernel": 0,
                                 "flash_attention": 0, "ssd": 0,
                                 "ssd_bwd": 0}


def _ssd_bwd_args(b=1, S=8, H=2, P=16, G=1, N=16, chunk=8):
    """ssd_bwd's arguments at a shape, zeros: the inputs, the forward's
    scratch and final state (C·Bᵀ (b, G, nc, QP, QP), the entering states
    (b, nc - 1, H, P, N)), dL/dy and no dL/d(final state)."""
    Q = min(chunk, S)
    nc, QP = -(-S // Q), -(-Q // 64) * 64
    return (torch.zeros(b, S, H, P), torch.zeros(b, S, H), torch.zeros(H),
            torch.zeros(b, S, G, N), torch.zeros(b, S, G, N),
            torch.zeros(b, G, nc, QP, QP), torch.zeros(b, nc - 1, H, P, N),
            torch.zeros(b, H, P, N), torch.zeros(b, S, H, P), None)


@pytest.mark.parametrize("bad,match", [
    (dict(N=24), "state dim"),            # a state width the kernel lacks
    (dict(P=24), "multiple of 16"),       # P not a multiple of 16
    (dict(S=300, chunk=300), "exceeds"),  # a chunk over 256 rows
    (dict(H=3, G=2), "groups"),           # G not dividing H
])
def test_ssd_bwd_refuses_shapes_it_does_not_take(bad, match):
    """The backward wrapper checks the shape before the device, so a CPU
    call shows the shape refusal; nothing launches."""
    SSD.ssd_bwd.launches = 0
    kw = dict(bad)
    chunk = kw.pop("chunk", 8)
    with pytest.raises(ValueError, match=match):
        SSD.ssd_bwd(*_ssd_bwd_args(chunk=chunk, **kw), chunk=chunk)
    assert SSD.ssd_bwd.launches == 0


@pytest.mark.parametrize("init", [False, True])
def test_ssd_function_on_cpu_takes_the_plain_backward(init):
    """A CPU tensor keeps the plain recompute-and-autograd backward: its
    gradients equal autograd through ``plain_ssd`` bit for bit, and the
    backward kernel's counter stays at 0."""
    from repro_torch.kernels.ssd.ops import plain_ssd, ssd

    g = torch.Generator().manual_seed(4)
    x, gy = (torch.randn(2, 100, 4, 16, generator=g) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(2, 100, 4, generator=g))
    A = -torch.exp(torch.randn(4, generator=g) * 0.3)
    B, C = (torch.randn(2, 100, 2, 16, generator=g) * 0.3 for _ in range(2))
    base = [x, dt * 0.1, A, B, C]
    if init:
        base.append(torch.randn(2, 4, 16, 16, generator=g))
    SSD.ssd_bwd.launches = 0
    ins = [t.clone().requires_grad_() for t in base]
    y, _ = ssd(*ins[:5], chunk=64, initial_state=ins[5] if init else None)
    got = torch.autograd.grad(y, ins, gy)
    pins = [t.clone().requires_grad_() for t in base]
    yr, _ = plain_ssd(*pins[:5], 64, pins[5] if init else None)
    want = torch.autograd.grad(yr, pins, gy)
    assert SSD.ssd_bwd.launches == 0
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_codes_equal_jax(bits, stochastic, impl):
    y, rbits, s = random_inputs(4, 1000)
    if not stochastic:
        rbits = np.full(y.shape, 1 << 31, np.uint32)   # u = 0.5
    qj = JQ.encode_leaf(jnp.asarray(y), jnp.asarray(rbits), jnp.asarray(s),
                        bits=bits, impl=impl)
    qt = TQ.encode_leaf(torch.from_numpy(y), bits_i32(rbits),
                        torch.from_numpy(s), bits=bits)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def _codes_equal_jax(y, words, s, bits, impl):
    """The port's plain version and its ``encode_leaf`` give JAX's
    ``encode_leaf`` codes, bit for bit."""
    qj = np.asarray(JQ.encode_leaf(jnp.asarray(y), jnp.asarray(words),
                                   jnp.asarray(s), bits=bits, impl=impl))
    yt, wt, st = torch.from_numpy(y.copy()), bits_i32(words), \
        torch.from_numpy(s.copy())
    plain = TQR.quantize_ref(yt, wt, st[:, None], bits=bits)
    qt = TQ.encode_leaf(yt, wt, st, bits=bits)
    assert qt.dtype == torch.int8 and qt.shape == y.shape
    np.testing.assert_array_equal(plain.numpy(), qj)
    np.testing.assert_array_equal(qt.numpy(), qj)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("N,M", [(1, 1), (3, 3), (3, 96), (2, 785),
                                 (3, 4099)])
def test_quantize_ragged_rows_equal_jax(N, M, bits, impl):
    """Rows of 1, 3, 785 and 4,099 columns (no multiple of 4: the CUDA
    kernel's scalar instantiation) and of 96 (its vector one)."""
    _codes_equal_jax(*random_inputs(N, M, seed=7 * N + M), bits, impl)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_quantize_edges_equal_jax(case, bits, impl):
    """floor() on an exact integer with u = 0, the clip at y = +-s, -0.0,
    the words that round u to 1.0, and the constant 1 << 31 word."""
    _codes_equal_jax(*edge_inputs(case, bits), bits, impl)


def test_uniform_from_bits_rounds_top_words_to_one():
    words = np.array([0, 1 << 31, 2 ** 32 - 129, 2 ** 32 - 128,
                      2 ** 32 - 1], np.uint32)
    u = TQR.uniform_from_bits(bits_i32(words)).numpy()
    np.testing.assert_array_equal(
        u, (words.astype(np.float32) * np.float32(2.0 ** -32)))
    assert u[3] == 1.0 and u[4] == 1.0 and u[2] < 1.0 and u[1] == 0.5


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_single_leaf_and_scale_equal_jax(bits):
    rng = np.random.RandomState(3)
    x = rng.randn(37, 5).astype(np.float32)
    rbits = rng.randint(0, 2 ** 32, size=x.shape, dtype=np.uint64) \
        .astype(np.uint32)
    sj = JQ.compute_scale(jnp.asarray(x))
    st = TQ.compute_scale(torch.from_numpy(x))
    assert float(st) == float(sj)
    qj = JQ.quantize(jnp.asarray(x), jnp.asarray(rbits), sj, bits=bits,
                     impl="interpret")
    qt = TQ.quantize(torch.from_numpy(x), bits_i32(rbits), st, bits=bits)
    assert qt.shape == (37, 5)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_row_scales_equal_jax_reducer():
    """The compressed round's per-client scales: the JAX reducer's
    max(max|y| over the row, 1e-12), an all-zero row taking the floor."""
    y, _, _ = random_inputs(5, 300, seed=4)
    y[2] = 0.0
    sj = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(y)), axis=1), 1e-12)
    st = TQ.compute_scale(torch.from_numpy(y), dim=1)
    assert st.shape == (5,) and st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[2]) == np.float32(1e-12)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_mean_matches_jax(bits, impl):
    y, rbits, s = random_inputs(6, 3000, seed=1)
    q = np.asarray(JQ.encode_leaf(jnp.asarray(y), jnp.asarray(rbits),
                                  jnp.asarray(s), bits=bits))
    mj = JQ.dequant_mean(jnp.asarray(q), jnp.asarray(s), bits=bits, impl=impl)
    mt = TQ.dequant_mean(torch.from_numpy(q.copy()), torch.from_numpy(s),
                         bits=bits)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_mean_leaf_deq_exactly_equal(bits):
    y, rbits, s = random_inputs(5, 2000, seed=2)
    q = np.asarray(JQ.encode_leaf(jnp.asarray(y), jnp.asarray(rbits),
                                  jnp.asarray(s), bits=bits))
    dj, mj = JQ.decode_mean_leaf(jnp.asarray(q), jnp.asarray(s), bits=bits)
    dt, mt = TQ.decode_mean_leaf(torch.from_numpy(q.copy()),
                                 torch.from_numpy(s), bits=bits)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)


@pytest.mark.parametrize("bad", ["y_dtype", "bits_dtype", "scales_shape",
                                 "bits_shape", "one_dim"])
def test_quantize_rejects_bad_inputs(bad):
    y = torch.zeros(4, 8)
    rb = torch.zeros(4, 8, dtype=torch.int32)
    s = torch.ones(4)
    if bad == "y_dtype":
        y = y.double()
    elif bad == "bits_dtype":
        rb = rb.to(torch.int64)
    elif bad == "scales_shape":
        s = torch.ones(3)
    elif bad == "bits_shape":
        rb = torch.zeros(4, 9, dtype=torch.int32)
    else:
        y, rb = y.reshape(-1), rb.reshape(-1)
    with pytest.raises(ValueError):
        TQ.encode_leaf(y, rb, s)
