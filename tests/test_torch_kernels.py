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
from repro.kernels.fused_update.ops import sgd_update as j_sgd_update
from repro.kernels.quantize import ops as JQ
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.fused_update import ops as TF
from repro_torch.kernels.fused_update.kernel import fused_sgd_update
from repro_torch.kernels.fused_update.ref import sgd_update_ref
from repro_torch.kernels.quantize import ops as TQ
from repro_torch.kernels.quantize import ref as TQR
from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)

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
    assert K.launch_counts() == {"fused_sgd_update": 0, "quantize_kernel": 0,
                                 "dequant_mean_kernel": 0,
                                 "flash_attention": 0}


def _quant_inputs(N=4, M=1000, seed=0):
    rng = np.random.RandomState(seed)
    y = (rng.randn(N, M) * rng.rand(N, 1)).astype(np.float32)
    bits = rng.randint(0, 2 ** 32, size=(N, M), dtype=np.uint64) \
        .astype(np.uint32)
    # the rounding edge: words at or above 2^32 - 128 read as u = 1.0
    bits[0, :8] = 2 ** 32 - 1 - np.arange(8) * 40
    s = np.maximum(np.abs(y).max(axis=1), 1e-12).astype(np.float32)
    return y, bits, s


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_codes_equal_jax(bits, stochastic, impl):
    y, rbits, s = _quant_inputs()
    if not stochastic:
        rbits = np.full(y.shape, 1 << 31, np.uint32)   # u = 0.5
    qj = JQ.encode_leaf(jnp.asarray(y), jnp.asarray(rbits), jnp.asarray(s),
                        bits=bits, impl=impl)
    qt = TQ.encode_leaf(torch.from_numpy(y), bits_i32(rbits),
                        torch.from_numpy(s), bits=bits)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


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
    y, _, _ = _quant_inputs(N=5, M=300, seed=4)
    y[2] = 0.0
    sj = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(y)), axis=1), 1e-12)
    st = TQ.compute_scale(torch.from_numpy(y), dim=1)
    assert st.shape == (5,) and st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[2]) == np.float32(1e-12)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_mean_matches_jax(bits, impl):
    y, rbits, s = _quant_inputs(N=6, M=3000, seed=1)
    q = np.asarray(JQ.encode_leaf(jnp.asarray(y), jnp.asarray(rbits),
                                  jnp.asarray(s), bits=bits))
    mj = JQ.dequant_mean(jnp.asarray(q), jnp.asarray(s), bits=bits, impl=impl)
    mt = TQ.dequant_mean(torch.from_numpy(q.copy()), torch.from_numpy(s),
                         bits=bits)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_mean_leaf_deq_exactly_equal(bits):
    y, rbits, s = _quant_inputs(N=5, M=2000, seed=2)
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
