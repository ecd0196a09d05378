"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips at run time where there is no CUDA card
(the Hopper kernels have no CPU mode). This file imports no JAX, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as the CPU parity tests state them: the fused update 1e-6 in
float32 and 1e-2 in bfloat16 (the multi-leaf launch: bit-equal to the
plain version in float32, since both round every operation on its own in
the same order), quantize codes exactly equal, dequant_mean 1e-6. Flash
attention: 1e-5 in float32 (the kernel sums the same float32 products in
another order); in bfloat16 the tolerance of
``kernels/flash_attention/ref.py`` (elementwise 5e-3 + 1e-2 |ref|, each
query row of each head within 1e-2 of its norm). The SSD scan: the JAX
package's own tolerances (``tests/test_ssd_kernel.py``), 3e-4 in float32
for y and the final state, 5e-2 for y from bfloat16 inputs (y is rounded
to bfloat16). The SSD backward kernel against autograd through the plain
version: every gradient within the forward's tolerances of its largest
magnitude (3e-4 from float32 inputs, 5e-2 from bfloat16), as the CPU
tests hold gradients that sum the same function in another order (here
also over split bf16 products: the kernel is not bit-equal to the plain
backward); a gradient the plain version gives as zero is zero. The MoE layer and the int8 KV cache, card against CPU: the
same expert assignment and the output within 1e-5 (float32), the cache's
codes and scales bit-equal; the zero-padded MLA flash call against the
plain attention on the unpadded head dims, with flash's tolerances.
recurrentgemma-2b and internvl2-2b SMOKE (float32), card against CPU:
logits within 1e-4 through a prefill and 8 decode steps.
"""
import math

import numpy as np
import pytest
import torch
from quant_cases import EDGE_CASES, edge_inputs

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     bf16_mismatch)
from repro_torch.kernels.fused_update.kernel import (MAX_LEAVES,
                                                     fused_sgd_update)
from repro_torch.kernels.fused_update.ops import tree_sgd_update_
from repro_torch.kernels.fused_update.ref import (sgd_update_ref,
                                                  tree_sgd_update_ref)
from repro_torch.kernels.quantize import ops as TQ
from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)
from repro_torch.kernels.quantize.ref import dequant_mean_ref, quantize_ref
from repro_torch.kernels.ssd import kernel as SSD
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 784), (32, 96, 96), (7,)])
def test_fused_update_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    p, m, gr = (torch.randn(shape, generator=g, device=cuda)
                for _ in range(3))
    p, gr = p.to(dtype), gr.to(dtype)
    pr, mr = sgd_update_ref(p, m, gr, eta=0.05, beta=0.9, wd=1e-4)
    before = fused_sgd_update.launches
    out = fused_sgd_update(p, m, gr, eta=0.05, beta=0.9, wd=1e-4)
    torch.cuda.synchronize()
    assert out[0] is p and fused_sgd_update.launches == before + 1
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(p.float(), pr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, mr, atol=tol, rtol=tol)


_DTYPE_PAIRS = [(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16)]
_LENGTHS = [1, 3, 5, 96, 75264]


def _tree(dev, n_leaves, p_dtype, m_dtype, seed=0):
    """n_leaves (p, m, g) leaves cycling through _LENGTHS, stacked over 4
    clients for the longer ones; leaf 1 (where there is one) is a
    contiguous view at an odd element offset, so its base is not 16-byte
    aligned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ps, ms, gs = [], [], []
    for i in range(n_leaves):
        n = _LENGTHS[i % len(_LENGTHS)]
        shape = (4, n) if n > 5 else (n,)
        off = 1 if i == 1 else 0
        make = lambda dt: torch.randn(off + math.prod(shape), generator=g,
                                      device=dev).to(dt)[off:].view(shape)
        ps.append(make(p_dtype))
        ms.append(make(m_dtype))
        gs.append(make(p_dtype))
    return ps, ms, gs


@pytest.mark.parametrize("p_dtype, m_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("n_leaves", [1, 8, MAX_LEAVES + 3])
def test_multi_leaf_update_matches_plain(cuda, n_leaves, p_dtype, m_dtype):
    ps, ms, gs = _tree(cuda, n_leaves, p_dtype, m_dtype)
    if n_leaves > 1:
        assert ps[1].data_ptr() % 16 and ms[1].data_ptr() % 16
    want_p, want_m = tree_sgd_update_ref(ps, ms, gs, eta=0.05, beta=0.9,
                                         wd=1e-4)
    before = fused_sgd_update.launches
    out = tree_sgd_update_(ps, ms, gs, eta=0.05, beta=0.9, wd=1e-4)
    torch.cuda.synchronize()
    assert out[0] is ps
    assert fused_sgd_update.launches == before + -(-n_leaves // MAX_LEAVES)
    for got, want in zip(ps + ms, want_p + want_m):
        if got.dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                       rtol=1e-2)


def test_multi_leaf_update_of_the_mlp_tree_is_one_launch(cuda):
    # the simulator's MLP tree, 8 leaves stacked over 32 clients, float32:
    # one launch per local step, bit-equal to the plain version
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves, tree_map
    p0 = mlp.init_params(784, width=96, depth=3, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    rand = lambda t: torch.randn((32,) + tuple(t.shape), generator=g,
                                 device=cuda)
    params, moms, grads = (tree_map(rand, p0) for _ in range(3))
    assert len(tree_leaves(params)) == 8
    want_p, want_m = tree_sgd_update_ref(
        tree_leaves(params), tree_leaves(moms), tree_leaves(grads), eta=0.5,
        beta=0.9)
    before = fused_sgd_update.launches
    tree_sgd_update_(params, moms, grads, eta=0.5, beta=0.9)
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 1
    for got, want in zip(tree_leaves(params) + tree_leaves(moms),
                         want_p + want_m):
        assert torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 96, 785, 1 << 20])
@pytest.mark.parametrize("N", [1, 3, 32, 33])
def test_dequant_mean_matches_plain_at_any_shape(cuda, N, M):
    g = torch.Generator(device=cuda).manual_seed(N * 7 + M)
    q = torch.randint(-127, 128, (N, M), dtype=torch.int8, generator=g,
                      device=cuda)
    s = torch.rand((N,), generator=g, device=cuda) + 0.01
    before = dequant_mean_kernel.launches
    mean = dequant_mean_kernel(q, s)
    torch.cuda.synchronize()
    assert dequant_mean_kernel.launches == before + 1
    assert mean.shape == (M,) and mean.dtype == torch.float32
    torch.testing.assert_close(mean, dequant_mean_ref(q, s), atol=1e-6,
                               rtol=1e-6)
    # a view at an odd offset: every row is read byte by byte
    qv = torch.empty(N * M + 1, dtype=torch.int8, device=cuda)[1:]
    qv.copy_(q.reshape(-1))
    torch.testing.assert_close(dequant_mean_kernel(qv.view(N, M), s), mean,
                               atol=0, rtol=0)


def _quantize_checked(y, rb, s, bits):
    """quantize_kernel's codes, bit-equal to the plain version's; one
    launch per call."""
    before = quantize_kernel.launches
    q = quantize_kernel(y, rb, s, bits=bits)
    torch.cuda.synchronize()
    assert quantize_kernel.launches == before + 1
    assert q.shape == y.shape and q.dtype == torch.int8
    want = quantize_ref(y, rb, s[:, None], bits=bits)
    assert torch.equal(q, want), f"{int((q != want).sum())} codes differ"
    return q


def _odd_view(t):
    """A copy of t at an odd element offset of a flat buffer: contiguous,
    but its rows are not 16-byte aligned (the scalar instantiation)."""
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    v.copy_(t.reshape(-1))
    return v.view(t.shape)


def _to_card(cuda, y, words, s):
    return (torch.from_numpy(y).to(cuda),
            torch.from_numpy(words.view(np.int32)).to(cuda),
            torch.from_numpy(s).to(cuda))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("M", [1, 3, 96, 784, 785, 70001, 75264, 1 << 20])
@pytest.mark.parametrize("N", [1, 3, 32, 33])
def test_quantize_and_dequant_match_plain(cuda, N, M, bits):
    g = torch.Generator(device=cuda).manual_seed(N * 7 + M)
    y = torch.randn((N, M), generator=g, device=cuda) \
        * torch.rand((N, 1), generator=g, device=cuda)
    rb = torch.randint(-2 ** 31, 2 ** 31, (N, M), dtype=torch.int32,
                       generator=g, device=cuda)
    rb[0, :1] = -1                      # 2^32 - 1: u rounds to 1.0
    s = TQ.compute_scale(y, dim=1)
    q = _quantize_checked(y, rb, s, bits)
    mean = dequant_mean_kernel(q, s, bits=bits)
    torch.testing.assert_close(mean, dequant_mean_ref(q, s, bits=bits),
                               atol=1e-6, rtol=1e-6)
    deq, mean2 = TQ.decode_mean_leaf(q, s, bits=bits)
    assert torch.equal(mean2, mean) and deq.shape == (N, M)


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("which", ["y", "bits", "both"])
@pytest.mark.parametrize("N,M", [(3, 96), (32, 784), (33, 785),
                                 (32, 1 << 20)])
def test_quantize_odd_offset_views_match_plain(cuda, N, M, which, bits):
    """y or the words at an odd offset take the scalar instantiation; its
    codes equal the aligned call's and the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(M)
    y = torch.randn((N, M), generator=g, device=cuda)
    rb = torch.randint(-2 ** 31, 2 ** 31, (N, M), dtype=torch.int32,
                       generator=g, device=cuda)
    s = TQ.compute_scale(y, dim=1)
    aligned = _quantize_checked(y, rb, s, bits)
    yv = _odd_view(y) if which in ("y", "both") else y
    rv = _odd_view(rb) if which in ("bits", "both") else rb
    assert torch.equal(_quantize_checked(yv, rv, s, bits), aligned)


@pytest.mark.parametrize("view", ["aligned", "odd"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_quantize_edges_match_plain(cuda, case, bits, view):
    """floor() on an exact integer with u = 0, the clip at y = +-s, -0.0,
    words at or above 2^32 - 128 (u = 1.0) and the constant 1 << 31 word,
    on the vector and the scalar instantiation."""
    y, rb, s = _to_card(cuda, *edge_inputs(case, bits))
    if view == "odd":
        y, rb = _odd_view(y), _odd_view(rb)
    _quantize_checked(y, rb, s, bits)


def test_wrappers_raise_on_bad_cuda_inputs(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_sgd_update(x, x.clone(), torch.zeros(4, 8),   # g on the CPU
                         eta=0.1)
    with pytest.raises(ValueError):
        quantize_kernel(x, torch.zeros(4, 8, dtype=torch.int32, device=cuda),
                        torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        dequant_mean_kernel(torch.zeros(4, 8, device=cuda),
                            torch.ones(4, device=cuda))


# (B, Sq, Sk, H, KV, D, causal, window, softcap)
FLASH_CASES = [
    (1, 200, 200, 4, 2, 64, True, None, None),      # ragged, one tile short
    (2, 256, 256, 8, 2, 128, True, 64, 50.0),       # window + softcap
    (1, 130, 130, 4, 4, 256, True, None, 30.0),     # D = 256
    (1, 3, 130, 4, 1, 128, True, 32, None),         # queries at the kv tail
    (1, 96, 160, 2, 2, 64, False, None, None),      # non-causal, Sq < Sk
    # the bf16 kernel's tile edges: BQ = 128 query rows (64 at D = 256),
    # BK = 144 kv rows at D = 128 (128 at D = 64, 64 at D = 256)
    (1, 1, 1, 4, 2, 128, True, None, None),
    (1, 145, 145, 4, 2, 128, True, None, None),
    (1, 144, 288, 4, 2, 128, True, None, None),
    (1, 127, 127, 4, 2, 128, True, None, None),
    (1, 128, 128, 4, 2, 128, True, None, None),
    (1, 129, 129, 4, 2, 128, True, None, None),
    (1, 257, 257, 4, 2, 128, True, None, None),
    (1, 1, 129, 4, 2, 128, True, None, None),       # one query, ragged Sk
    (1, 127, 257, 4, 2, 128, True, None, None),
    (1, 300, 1000, 4, 2, 128, True, None, None),    # Sq < Sk, ragged Sk
    (1, 300, 300, 4, 2, 128, True, 1, None),        # windows at the edges
    (1, 300, 300, 4, 2, 128, True, 127, None),
    (1, 300, 300, 4, 2, 128, True, 128, None),
    (1, 300, 300, 4, 2, 128, True, 129, None),
    (1, 200, 200, 4, 4, 128, True, None, None),     # GQA group 1
    (1, 200, 200, 40, 8, 128, True, None, None),    # group 5 (qwen3 40/8)
    (1, 200, 200, 8, 1, 128, True, None, None),     # group 8
    (2, 200, 200, 4, 2, 128, True, None, None),     # no row crosses a batch
    (1, 257, 257, 4, 2, 64, True, None, 50.0),      # D = 64 with softcap
    (1, 257, 257, 4, 2, 256, True, None, 50.0),     # D = 256 with softcap
    (1, 300, 1000, 4, 2, 128, False, None, None),   # non-causal, Sq < Sk
    (1, 512, 512, 10, 1, 256, True, 128, None),     # MQA group 10, D = 256
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, KV, D, causal, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(2)
    # with a softcap, q is scaled by cap / 4 so that the scores spread to
    # about +-cap, where cap * tanh(s / cap) bends away from s
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda)
    q = (q * (cap / 4 if cap else 1.0)).to(dtype)
    k = torch.randn((B, Sk, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, D), generator=g, device=cuda).to(dtype)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        err, elem, row = bf16_mismatch(out, ref)
        assert elem <= 1.0 and row <= 1.0, (err, elem, row)
    if cap:   # control: a kernel that left the cap out fails these inputs
        nocap = attention_ref(q, k, v, causal=causal, window=window)
        if dtype == torch.float32:
            assert not torch.allclose(out, nocap, atol=1e-5, rtol=1e-5)
        else:
            err, elem, row = bf16_mismatch(out, nocap)
            assert elem > 1.0 or row > 1.0, (err, elem, row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("scale, window, cap", [
    (-0.1, None, None), (0.0, None, None), (-0.1, 100, None),
    (-0.1, None, 30.0)])
def test_flash_attention_takes_any_scale(cuda, D, scale, window, cap, dtype):
    # as attention_ref does: a scale <= 0 turns the order of the scores
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((2, 300, n, D), generator=g,
                           device=cuda).to(dtype) for n in (4, 2, 2))
    out = FA.flash_attention(q, k, v, window=window, softcap=cap, scale=scale)
    ref = attention_ref(q, k, v, window=window, softcap=cap, scale=scale)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        err, elem, row = bf16_mismatch(out, ref)
        assert elem <= 1.0 and row <= 1.0, (err, elem, row)


def test_flash_attention_raises_on_unsupported_cuda_inputs(cuda):
    before = FA.flash_attention.launches
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):                      # D = 96
        FA.flash_attention(torch.zeros(1, 8, 2, 96, device=cuda),
                           torch.zeros(1, 8, 2, 96, device=cuda),
                           torch.zeros(1, 8, 2, 96, device=cuda))
    with pytest.raises(TypeError):                       # float16
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                      # not contiguous
        FA.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                           q)
    off = torch.zeros(8 * 2 * 64 + 1, device=cuda,       # 2-byte aligned
                      dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError):
        FA.flash_attention(off, off, off)
    # the bf16 kernel reads q, k, v through 4-D TMA maps, which need a
    # 16-byte aligned base and dense rows: a k that is only 8-byte aligned,
    # or a v whose heads are strided, raises before any launch
    qb = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.bfloat16)
    kb = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    k8 = torch.zeros(8 * 2 * 64 + 4, device=cuda,        # 8-byte aligned
                     dtype=torch.bfloat16)[4:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention(qb, k8, kb)
    v_strided = torch.zeros(1, 8, 4, 64, device=cuda,
                            dtype=torch.bfloat16)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(qb, kb, v_strided)
    assert FA.flash_attention.launches == before


def _ssd_inputs(dev, b, S, H, P, G, N, dtype=torch.float32, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = (rn(b, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn(b, S, H)) * 0.1
    A = -torch.exp(rn(H) * 0.3)
    B = (rn(b, S, G, N) * 0.3).to(dtype)
    C = (rn(b, S, G, N) * 0.3).to(dtype)
    return x, dt, A, B, C


# (b, S, H, P, G, N, chunk)
SSD_CASES = [
    (1, 128, 2, 32, 1, 16, 64),
    (2, 256, 4, 64, 1, 32, 128),
    (2, 256, 4, 64, 2, 32, 64),        # grouped B/C
    (1, 200, 4, 32, 2, 16, 64),        # ragged: a 8-row last chunk
    (1, 37, 2, 16, 1, 32, 256),        # one chunk shorter than a tile
    (1, 1000, 80, 64, 1, 128, 256),    # mamba2-2.7b's heads, 232-row tail
    (1, 129, 2, 32, 1, 32, 64),        # last chunk of 1 row
    (1, 127, 2, 32, 1, 32, 64),        # last chunk of 63 rows
    (1, 192, 2, 32, 1, 32, 64),        # last chunk of 64 rows (full)
    (1, 193, 2, 32, 1, 32, 128),       # last chunk of 65 rows
    (1, 319, 2, 64, 1, 128, 256),      # last chunk of 63 rows at chunk 256
    (2, 256, 4, 64, 1, 128, 256),      # a single chunk (nc = 1)
    (1, 300, 8, 32, 4, 32, 128),       # G = 4 with H = 8
    (2, 100, 4, 16, 1, 16, 64),        # P = 16 with N = 16
    (1, 130, 2, 128, 1, 32, 64),       # P = 128: two 64-column tiles of P
    (1, 70, 2, 80, 1, 16, 64),         # P = 80: a 16-column second tile
    (1, 1, 2, 32, 1, 16, 64),          # S = 1
]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_plain(cuda, case, dtype, init):
    b, S, H, P, G, N, chunk = case
    x, dt, A, B, C = _ssd_inputs(cuda, b, S, H, P, G, N, dtype)
    h0 = None
    if init:   # a state as large as a chunk's: the first chunk reads it
        g = torch.Generator(device=cuda).manual_seed(S)
        h0 = torch.randn((b, H, P, N), generator=g, device=cuda)
    before = SSD.ssd.launches
    y, st = SSD.ssd(x, dt, A, B, C, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert SSD.ssd.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (b, H, P, N)
    yr, sr = ssd_chunked_ref(x, dt, A, B, C, chunk, h0)
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), yr, atol=tol, rtol=tol)
    torch.testing.assert_close(st, sr, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_strong_decay_matches_recurrence(cuda, dtype):
    # dt x 10: exp(cums) falls to about 1e-30 within a chunk of 100 rows,
    # so the decay spans the float32 range and the split's lo parts can be
    # denormal; held to the sequential recurrence
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 300, 4, 64, 1, 128, dtype)
    dt = dt * 10
    assert float(torch.exp((dt[0, :100] * A).sum(0)).min()) < 1e-25
    before = SSD.ssd.launches
    y, st = SSD.ssd(x, dt, A, B, C, chunk=100)
    torch.cuda.synchronize()
    assert SSD.ssd.launches == before + 1
    yr, sr = ssd_ref(x, dt, A, B, C)
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), yr, atol=tol, rtol=tol)
    torch.testing.assert_close(st, sr, atol=tol, rtol=tol)


def test_ssd_plain_versions_agree_on_the_card(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 200, 4, 32, 2, 16)
    yc, sc = ssd_chunked_ref(x, dt, A, B, C, 64)
    yr, sr = ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(yc, yr, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(sc, sr, atol=3e-4, rtol=3e-4)


def test_ssd_raises_on_unsupported_inputs(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 4, 32, 2, 16)
    cpu = [t.cpu() for t in (x, dt, A, B, C)]
    with pytest.raises(ValueError):                      # CPU tensors
        SSD.ssd(*cpu)
    with pytest.raises(ValueError):                      # not contiguous
        SSD.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C)
    with pytest.raises(ValueError):                      # dt of another S
        SSD.ssd(x, dt[:, :32].contiguous(), A, B, C)
    with pytest.raises(ValueError):                      # 3 groups, 4 heads
        B3 = torch.zeros(1, 64, 3, 16, device=cuda)
        SSD.ssd(x, dt, A, B3, B3)
    with pytest.raises(ValueError):                      # N = 24
        B24 = torch.zeros(1, 64, 2, 24, device=cuda)
        SSD.ssd(x, dt, A, B24, B24)
    with pytest.raises(ValueError):                      # chunk > 256
        SSD.ssd(*_ssd_inputs(cuda, 1, 300, 2, 16, 1, 16), chunk=300)
    with pytest.raises(TypeError):                       # mixed types
        SSD.ssd(x, dt, A, B.bfloat16(), C)
    h0 = torch.zeros(1, 4, 32, 16, device=cuda)
    with pytest.raises(ValueError):                      # a CPU state
        SSD.ssd(x, dt, A, B, C, initial_state=h0.cpu())
    with pytest.raises(ValueError):                      # a strided state
        SSD.ssd(x, dt, A, B, C,
                initial_state=torch.zeros(1, 4, 16, 32,
                                          device=cuda).transpose(2, 3))
    off = torch.zeros(1 + h0.numel(), device=cuda)[1:].view(h0.shape)
    with pytest.raises(ValueError, match="aligned"):     # 4-byte aligned
        SSD.ssd(x, dt, A, B, C, initial_state=off)


def test_simulator_runs_through_the_kernels(cuda):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp

    x, y = make_binary_classification(n=256, d=32, seed=0)
    data = {k: torch.from_numpy(v)
            for k, v in partition_iid(x, y, 4, seed=1).items()}
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=16, k1=4.0, n_stages=2,
                      batch_per_client=8, reducer="int8",
                      topology="streaming")
    K.reset_launch_counts()
    hist = simulate.run(lambda p, b: mlp.loss_fn(p, b, 1e-3),
                        mlp.init_params(32, width=16, depth=3), data, cfg,
                        lambda p: mlp.full_objective(p, xt, yt, 1e-3))
    counts = K.launch_counts()
    assert counts["fused_sgd_update"] == 48       # one launch per step
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] == 8 * 8
    vals = np.array([r.value for r in hist])
    assert np.isfinite(vals).all() and vals[-1] < 0.9 * vals[0]


# the event runtime's shapes: Table 5's MLP (d = 96, width 96, depth 3)
# leaf sizes, each a one-row block in an async upload
_TABLE5_MLP_LEAVES = [96, 9216, 96, 9216, 96, 9216, 1, 96]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("view", ["aligned", "odd"])
@pytest.mark.parametrize("M", sorted(set(_TABLE5_MLP_LEAVES)))
def test_one_row_encode_and_decode_match_plain(cuda, M, view, bits):
    """An async upload's leaf: ``encode_leaf`` / ``decode_mean_leaf`` on a
    (1, M) block through the same wrappers as the barrier round, one
    launch each; codes bit-equal to the plain version, the dequantized
    message and the mean within 1e-6."""
    g = torch.Generator(device=cuda).manual_seed(M)
    y = torch.randn((1, M), generator=g, device=cuda) * 0.01
    if view == "odd":   # not 16-byte aligned: the scalar instantiation
        y = torch.empty(M + 1, device=cuda)[1:].view(1, M).copy_(y)
    rb = torch.randint(-2 ** 31, 2 ** 31, (1, M), dtype=torch.int32,
                       generator=g, device=cuda)
    s = TQ.compute_scale(y, dim=1)
    q0, d0 = quantize_kernel.launches, dequant_mean_kernel.launches
    q = TQ.encode_leaf(y, rb, s, bits=bits)
    deq, mean = TQ.decode_mean_leaf(q, s, bits=bits)
    torch.cuda.synchronize()
    assert (quantize_kernel.launches, dequant_mean_kernel.launches) == \
        (q0 + 1, d0 + 1)
    qr = quantize_ref(y.cpu(), rb.cpu(), s.cpu()[:, None], bits=bits)
    assert torch.equal(q.cpu(), qr)
    deq_r, mean_r = TQ.decode_mean_leaf(qr, s.cpu(), bits=bits)
    torch.testing.assert_close(deq.cpu(), deq_r, atol=1e-6, rtol=0)
    torch.testing.assert_close(mean.cpu(), mean_r, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mask", [[True, False, True, False],
                                  [False, False, False, False],
                                  [True, True, False, True]])
def test_masked_step_restore_equals_where(cuda, mask):
    """The masked round's freeze: the dropped clients' rows saved before a
    fused step and written back after it equal ``torch.where`` of the
    stepped and the old rows, bit for bit."""
    from repro_torch.core.simulate import _freeze_rows
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves, tree_map

    p0 = mlp.init_params(96, width=96, depth=3, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    rand = lambda t: torch.randn((4,) + tuple(t.shape), generator=g,
                                 device=cuda)
    params, moms, grads = (tree_map(rand, p0) for _ in range(3))
    old = [t.clone() for t in tree_leaves(params) + tree_leaves(moms)]
    free_p, free_m = (tree_map(torch.clone, t) for t in (params, moms))
    tree_sgd_update_(free_p, free_m, grads, eta=0.5, beta=0.9)
    before = fused_sgd_update.launches
    restore = _freeze_rows(tree_leaves(params) + tree_leaves(moms), mask)
    tree_sgd_update_(params, moms, grads, eta=0.5, beta=0.9)
    restore()
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 1
    keep = torch.tensor(mask, device=cuda)
    for got, stepped, was in zip(tree_leaves(params) + tree_leaves(moms),
                                 tree_leaves(free_p) + tree_leaves(free_m),
                                 old):
        want = torch.where(keep.view((4,) + (1,) * (was.dim() - 1)),
                           stepped, was)
        assert torch.equal(got, want)


def test_one_client_tree_update_is_one_launch(cuda):
    """The async job's step: one client's unstacked MLP tree (8 leaves, the
    bias of the head a single float) in one launch, bit-equal to the
    plain version."""
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves, tree_map

    p0 = mlp.init_params(96, width=96, depth=3, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    rand = lambda t: torch.randn(t.shape, generator=g, device=cuda)
    params, moms, grads = (tree_map(rand, p0) for _ in range(3))
    assert [t.numel() for t in tree_leaves(params)] == _TABLE5_MLP_LEAVES
    want_p, want_m = tree_sgd_update_ref(
        tree_leaves(params), tree_leaves(moms), tree_leaves(grads), eta=0.5,
        beta=0.9)
    before = fused_sgd_update.launches
    tree_sgd_update_(params, moms, grads, eta=0.5, beta=0.9)
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 1
    for got, want in zip(tree_leaves(params) + tree_leaves(moms),
                         want_p + want_m):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw,tol", [
    (dict(dropout_rate=0.25), 1e-4),
    (dict(async_mode=True, dropout_rate=0.25), 1e-4),
    (dict(algo="adaptive", reducer="dense"), 1e-5)])
def test_runtime_runs_through_the_kernels(cuda, kw, tol):
    """The event runtime on the card: one fused update per local step (one
    client's under async_mode), one quantize and one dequant_mean per leaf
    per int8 round or staleness-int8 upload; the same event trace as the
    CPU run on the same draws, and the history within the CPU parity
    tests' tolerance of it (1e-4 int8, 1e-5 dense). The adaptive case runs
    dense: an int8 adaptive MLP run fires a round almost every step, and
    its history came 2.1e-4 from the CPU's after 40 rounds, past the int8
    tolerance stated for fixed-period runs. The int8 adaptive path is held
    on logreg (``test_adaptive_int8_logreg_matches_cpu``); ``chip_smoke.py``
    phase 11 logs, for the MLP, where its codes first differ from the
    CPU's and checks every block against the plain version."""
    from repro_torch import runtime
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp
    from repro_torch.utils.rng import TorchKey

    x, y = make_binary_classification(n=256, d=32, seed=0)
    data = {k: torch.from_numpy(v)
            for k, v in partition_iid(x, y, 4, seed=1).items()}
    cfg = TrainConfig(**dict(dict(algo="stl_sc", eta1=0.5, T1=16, k1=4.0,
                                  n_stages=2, batch_per_client=8,
                                  reducer="int8", straggler_frac=0.25,
                                  straggler_slowdown=2.0), **kw))
    p0 = mlp.init_params(32, width=16, depth=3)
    out = {}
    for dev in ("cpu", "cuda"):
        xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
        K.reset_launch_counts()
        out[dev] = runtime.run(lambda p, b: mlp.loss_fn(p, b, 1e-3), p0,
                               data, cfg,
                               lambda p: mlp.full_objective(p, xt, yt, 1e-3),
                               device=dev, rng=_HostKey(TorchKey(0), dev))
    counts = K.launch_counts()
    res = out["cuda"]
    assert res.trace == out["cpu"].trace
    np.testing.assert_allclose([r.value for r in res.history],
                               [r.value for r in out["cpu"].history],
                               atol=tol, rtol=0)
    # one encode per merge, or one reduce per round
    encodes = res.rounds if cfg.reducer == "int8" else 0
    assert counts["fused_sgd_update"] == res.iters
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] \
        == 8 * encodes


def test_adaptive_int8_logreg_matches_cpu(cuda):
    """The int8 adaptive period on the card against the CPU run on the
    same draws, on logreg (d = 32, N = 4): the same round lengths in every
    stage, the history within the int8 tolerance (1e-4), one fused update
    per local step and one quantize and one dequant_mean per round."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.engine import Engine
    from repro_torch.models import logreg
    from repro_torch.utils.rng import TorchKey

    class Rounds(simulate.VmapSimulatorBackend):
        def run_stage(self, stage, engine):
            status = super().run_stage(stage, engine)
            self.round_steps.append(list(self._last_round_steps))
            return status

    x, y = make_binary_classification(n=512, d=32, seed=0)
    data = {k: torch.from_numpy(v)
            for k, v in partition_iid(x, y, 4, seed=1).items()}
    cfg = TrainConfig(algo="adaptive", eta1=0.5, T1=32, k1=4.0, n_stages=3,
                      batch_per_client=8, reducer="int8", seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
        backend = Rounds(lambda p, b: logreg.loss_fn(p, b, 1e-2),
                         logreg.init_params(32), data,
                         lambda p: logreg.full_objective(p, xt, yt, 1e-2),
                         device=dev, rng=_HostKey(TorchKey(0), dev))
        backend.round_steps = []
        engine = Engine(cfg.algo, cfg)
        K.reset_launch_counts()
        hist = engine.run(backend)
        out[dev] = (backend.round_steps, [r.value for r in hist],
                    engine.report, K.launch_counts())
    (steps_c, hist_c, _, _), (steps_g, hist_g, rep, counts) = \
        out["cpu"], out["cuda"]
    assert steps_g == steps_c
    assert any(n < 4 for steps in steps_g for n in steps[:-1])
    np.testing.assert_allclose(hist_g, hist_c, atol=1e-4, rtol=0)
    assert counts["fused_sgd_update"] == rep.iters_total
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] \
        == rep.rounds_total == sum(len(s) for s in steps_g)


class _HostKey:
    """Draws made on the CPU and handed to ``device``, so that a run on
    the card and one on the CPU see the same draws."""

    def __init__(self, key, device):
        self.key, self.device = key, device

    def split(self, n):
        return [_HostKey(k, self.device) for k in self.key.split(n)]

    def fold_in(self, data):
        return _HostKey(self.key.fold_in(data), self.device)

    def batch_indices(self, n_clients, batch, high):
        return self.key.batch_indices(n_clients, batch, high).to(self.device)

    def client_batch_indices(self, batch, high):
        return self.key.client_batch_indices(batch, high).to(self.device)

    def bits(self, shape):
        return self.key.bits(shape).to(self.device)


@pytest.fixture
def f32_convs(cuda):
    """cuDNN convolutions in float32, the function the CPU computes (TF32
    is on for cuDNN by default); the previous setting restored after."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = old


def _stacked_mlp(dev, n=8, seed=0):
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_map

    p0 = mlp.init_params(24, width=16, depth=3, seed=seed)
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: (t[None] + 0.05 * torch.randn(
        (n,) + tuple(t.shape), generator=g)).to(dev), p0)


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("intra,inter", [("dense", "int8"), ("int8", "int8"),
                                         ("topk", "dense")])
def test_hierarchical_reduce_matches_cpu(cuda, intra, inter, streaming):
    """The two-level round on the card against the CPU on the same bits:
    consensus and every level's state within 1e-6 (a flipped int8 code
    would move a residual by scale/qmax); int8 hops launch one quantize
    and one dequant_mean per leaf per pod (intra) and per leaf (inter)."""
    from repro_torch.engine import get_topology
    from repro_torch.utils.rng import TorchKey
    from repro_torch.utils.tree import tree_leaves, tree_map

    topo = get_topology("streaming-hier" if streaming else "hier",
                        reducer=intra, inter_reducer=inter, topk_frac=0.2)
    out = {}
    for dev in ("cpu", "cuda"):
        st = _stacked_mlp(dev)
        state = topo.init_state(st)
        K.reset_launch_counts()
        for r in range(2):
            c, state = topo.reduce(st, state, _HostKey(TorchKey(r), dev))
            st = tree_map(lambda x: x * 0.9, st)
        out[dev] = (c, state, K.launch_counts())
    (cc, sc, _), (cg, sg, counts) = out["cpu"], out["cuda"]
    for a, b in zip(tree_leaves(cg) + tree_leaves(sg),
                    tree_leaves(cc) + tree_leaves(sc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
    n_leaves = len(tree_leaves(cc))
    hops = 2 * (intra == "int8") + (inter == "int8")
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] \
        == 2 * n_leaves * hops


@pytest.mark.parametrize("streaming", [False, True])
def test_dense_dense_hierarchical_equals_star_on_the_card(cuda, streaming):
    from repro_torch.engine import get_topology
    from repro_torch.utils.rng import TorchKey
    from repro_torch.utils.tree import tree_leaves

    st = _stacked_mlp(cuda, seed=2)
    hier = get_topology("streaming-hier" if streaming else "hier",
                        reducer="dense", inter_reducer="dense")
    star = get_topology("star")
    a, _ = hier.reduce(st, hier.init_state(st), TorchKey(0, cuda))
    b, _ = star.reduce(st, star.init_state(st), TorchKey(0, cuda))
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_hier_runtime_schedules_on_the_card(cuda):
    """Table 5d at a small size on the card: the MLP over the streaming
    two-level int8 round with a billed downlink, under three schedules —
    the same trace and ledger as the CPU run, parameters bit-equal across
    schedules, one fused update per local step and (P + 1) quantize and
    dequant_mean launches per leaf per round."""
    from repro_torch import runtime
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp
    from repro_torch.utils.rng import TorchKey
    from repro_torch.utils.tree import tree_leaves

    x, y = make_binary_classification(n=256, d=32, seed=0)
    data = {k: torch.from_numpy(v)
            for k, v in partition_iid(x, y, 8, seed=1).items()}
    p0 = mlp.init_params(32, width=16, depth=3)
    res = {}
    for sched in ("blocking", "streaming-uplink", "streaming"):
        cfg = TrainConfig(algo="sync", eta1=0.1, T1=8, n_stages=2,
                          batch_per_client=8, seed=0, reducer="int8",
                          inter_reducer="int8", topology="streaming-hier",
                          n_pods=2, count_downlink=True,
                          comm_latency_s=1e-4, comm_bandwidth_gbps=0.45,
                          straggler_frac=0.25, straggler_slowdown=4.0,
                          upload_schedule=sched)
        for dev in ("cpu", "cuda"):
            xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
            K.reset_launch_counts()
            res[sched, dev] = runtime.run(
                lambda p, b: mlp.loss_fn(p, b, 1e-3), p0, data, cfg,
                lambda p: mlp.full_objective(p, xt, yt, 1e-3), device=dev,
                rng=_HostKey(TorchKey(0), dev))
        counts = K.launch_counts()
        g, c = res[sched, "cuda"], res[sched, "cpu"]
        assert g.trace == c.trace and g.leaf_ledger == c.leaf_ledger
        assert g.wall_clock_s == c.wall_clock_s
        np.testing.assert_allclose([r.value for r in g.history],
                                   [r.value for r in c.history], atol=1e-4,
                                   rtol=0)
        assert counts["fused_sgd_update"] == g.iters
        assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] \
            == 3 * 8 * g.rounds
    blk = res["blocking", "cuda"]
    for sched in ("streaming-uplink", "streaming"):
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(res[sched, "cuda"].params),
                       tree_leaves(blk.params)))
    assert res["streaming", "cuda"].wall_clock_s < blk.wall_clock_s


@pytest.mark.parametrize("net,hw", [("resnet18", 16), ("resnet18", 15),
                                    ("vgg16", 32)])
def test_cnn_matches_cpu(f32_convs, net, hw):
    """ResNet18 / VGG16 (width 8) on the card against the CPU on the same
    weights: logits within 1e-5 and gradients within 1e-4 of their largest
    magnitude, as the CPU parity tests hold them to JAX."""
    from repro_torch.models import cnn
    from repro_torch.utils.tree import tree_leaves, tree_to

    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, hw, hw, 3), generator=g)
    y = torch.tensor([1, 4, 7], dtype=torch.int32)
    if net == "resnet18":
        p, strides = cnn.init_resnet18(0, width=8, device="cpu")
        fwd = lambda q, xb: cnn.apply_resnet18(q, strides, xb)
    else:
        p = cnn.init_vgg16(0, width=8, device="cpu")
        fwd = cnn.apply_vgg16
    out = {}
    for dev in ("cpu", "cuda"):
        q, xd, yd = tree_to(p, dev), x.to(dev), y.to(dev)
        out[dev] = (fwd(q, xd), torch.func.grad(
            lambda w: cnn.cross_entropy(fwd(w, xd), yd))(q))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lg.cpu(), lc, rtol=0,
                               atol=1e-5 * float(lc.abs().max()))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-12)


def test_cnn_simulator_runs_through_the_kernels(f32_convs):
    """stl_nc1 int8 on ResNet18 (width 4, 16×16, 4 Non-IID clients) on the
    card: one fused update per local step for the 38-leaf tree, one
    quantize and one dequant_mean per leaf per round; the history within
    the CPU parity tests' CNN tolerance of the CPU run on the same draws
    (first round 1e-5, all 1e-3)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_multiclass_images, partition_paper
    from repro_torch.models import cnn
    from repro_torch.utils.rng import TorchKey

    x, y = make_multiclass_images(n=64, hw=16, seed=0)
    data = {k: torch.from_numpy(v) for k, v in
            partition_paper(x, y, 4, iid_percent=0.0, seed=1).items()}
    p0, strides = cnn.init_resnet18(0, width=4, device="cpu")
    cfg = TrainConfig(algo="stl_nc1", eta1=0.005, T1=8, k1=4.0, n_stages=2,
                      gamma_inv=0.01, iid=False, batch_per_client=4,
                      momentum=0.9, reducer="int8", seed=0)
    fwd = lambda p, xb: cnn.apply_resnet18(p, strides, xb)
    out = {}
    for dev in ("cpu", "cuda"):
        xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
        K.reset_launch_counts()
        hist = simulate.run(lambda p, b: cnn.cross_entropy(fwd(p, b["x"]),
                                                           b["y"]),
                            p0, data, cfg,
                            lambda p: cnn.cross_entropy(fwd(p, xt), yt),
                            device=dev, chunk_rounds=2,
                            rng=_HostKey(TorchKey(0), dev))
        out[dev] = ([r.value for r in hist], hist[-1], K.launch_counts())
    (vc, _, _), (vg, last, counts) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(vg[:2], vc[:2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(vg, vc, atol=1e-3, rtol=0)
    assert counts["fused_sgd_update"] == last.iteration
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] \
        == 38 * last.round


# ---------------------------------------------------------------------------
# Training: the flash and SSD Functions' backward, the update of one
# client's bf16 rows; the profile session on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,B,S,H,KV,D,window,cap", [
    (torch.bfloat16, 2, 256, 8, 2, 128, None, None),
    (torch.bfloat16, 1, 300, 4, 4, 64, 64, 30.0),
    (torch.float32, 1, 200, 4, 2, 64, 64, 30.0),
])
def test_flash_gradients_equal_the_plain_route(cuda, dtype, B, S, H, KV, D,
                                               window, cap):
    """The kernel route's output has a grad_fn and its dq, dk, dv equal
    autograd through the plain version bit for bit (both differentiate
    the same recomputed plain attention)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         plain_attention)

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, S, H, D), generator=g, device=cuda)
    q = (q * (cap / 4 if cap else 1.0)).to(dtype)
    k, v = (torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    dout = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention.launches
    out = flash_attention(*ins, window=window, softcap=cap)
    assert out.grad_fn is not None
    assert FA.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, ins, dout)
    plain_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = plain_attention(*plain_ins, True, window, cap, None)
    want = torch.autograd.grad(ref, plain_ins, dout)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    if dtype == torch.bfloat16:
        _, elem, row = bf16_mismatch(out.detach(), attention_ref(
            q, k, v, window=window, softcap=cap))
        assert elem <= 1.0 and row <= 1.0
    else:
        torch.testing.assert_close(out.detach(), ref.detach(), atol=1e-5,
                                   rtol=1e-5)


def _grads_close(got, want, tol):
    """Each gradient within tol of its largest magnitude in the plain
    version, finite, in its input's type; zero where the plain one is."""
    for name, a, w in zip(("x", "dt", "A", "B", "C", "initial_state"), got,
                          want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        if not w.any():
            assert not a.any(), name
            continue
        err = float((a.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= tol, f"d{name}: {err}"


def _ssd_backward_pair(dev, case, dtype, init, use, strong=False):
    """The Function's gradients on the card (the backward kernel) and
    autograd through ``plain_ssd`` on the same inputs, for the loss
    sum(gy y) + sum(gs state) over the outputs in ``use``; the kernel
    route's gradients from two backwards, and the launches they took."""
    from repro_torch.kernels.ssd.ops import plain_ssd, ssd

    b, S, H, P, G, N, chunk = case
    x, dt, A, B, C = _ssd_inputs(dev, b, S, H, P, G, N, dtype)
    if strong:
        dt = dt * 10
    g = torch.Generator(device=dev).manual_seed(S + 1)
    base = [x, dt, A, B, C]
    if init:
        base.append(torch.randn((b, H, P, N), generator=g, device=dev))
    gy = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    gs = torch.randn((b, H, P, N), generator=g, device=dev)
    pick = lambda y, st: [(o, t) for o, t, u in ((y, gy, "y"), (st, gs, "s"))
                          if u in use]
    ins = [t.clone().requires_grad_() for t in base]
    y, st = ssd(*ins[:5], chunk=chunk, initial_state=ins[5] if init else None)
    outs, gouts = zip(*pick(y, st))
    before = SSD.ssd_bwd.launches
    got = torch.autograd.grad(outs, ins, gouts, retain_graph=True)
    again = torch.autograd.grad(outs, ins, gouts)
    torch.cuda.synchronize()
    launched = SSD.ssd_bwd.launches - before
    pins = [t.clone().requires_grad_() for t in base]
    yr, sr = plain_ssd(*pins[:5], chunk, pins[5] if init else None)
    routs, rgouts = zip(*pick(yr, sr))
    want = torch.autograd.grad(routs, pins, rgouts, allow_unused=True)
    # the final state does not reach C: the plain route's gradient is None
    want = [torch.zeros_like(p) if w is None else w
            for p, w in zip(pins, want)]
    return got, again, want, launched


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, case, dtype, init):
    """dL/dy into the backward kernel at every forward case: one launch a
    backward, two backwards bit-equal, the gradients held to the plain
    version's."""
    got, again, want, launched = _ssd_backward_pair(cuda, case, dtype, init,
                                                    ("y",))
    assert launched == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, want, 3e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("use", [("y",), ("s",), ("y", "s")])
@pytest.mark.parametrize("case", [(2, 256, 4, 64, 2, 32, 64),
                                  (1, 319, 2, 64, 1, 128, 256),
                                  (1, 1, 2, 32, 1, 16, 64)])
def test_ssd_backward_kernel_takes_either_output_gradient(cuda, case, use,
                                                          init):
    """dL/dy alone, dL/d(final state) alone (the kernel gets a zero dy), or
    both."""
    got, _, want, launched = _ssd_backward_pair(cuda, case, torch.float32,
                                                init, use)
    assert launched == 2
    _grads_close(got, want, 3e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_under_a_strong_decay(cuda, dtype):
    """The strong-decay inputs of the forward's test (exp(cums) about 1e-30
    within a chunk of 100 rows): every decay a difference of cumulative
    sums, and M's row and column sums cancelling in d(dt A) as the plain
    backward's do."""
    case = (1, 300, 4, 64, 1, 128, 100)
    got, again, want, launched = _ssd_backward_pair(cuda, case, dtype, False,
                                                    ("y",), strong=True)
    assert launched == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, want, 3e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("b,S,H,P,N,chunk", [
    (1, 64, 2, 64, 16, 64),
    (2, 300, 4, 64, 128, 128),      # a 44-row last chunk
])
def test_ssd_gradients_equal_the_plain_route(cuda, b, S, H, P, N, chunk,
                                             init):
    """The kernel route's y and final state have a grad_fn and their
    gradients in x, dt, A, B, C and the initial state, from the backward
    kernel (one launch), equal autograd through the plain version within
    3e-4 of each gradient's largest magnitude; under no_grad the call
    builds no graph."""
    from repro_torch.kernels.ssd.ops import plain_ssd, ssd

    x, dt, A, B, C = _ssd_inputs(cuda, b, S, H, P, 1, N)
    g = torch.Generator(device=cuda).manual_seed(S)
    h0 = torch.randn((b, H, P, N), generator=g, device=cuda) if init else None
    gy = torch.randn(x.shape, generator=g, device=cuda)
    gs = torch.randn((b, H, P, N), generator=g, device=cuda)
    base = [x, dt, A, B, C] + ([h0] if init else [])
    ins = [t.clone().requires_grad_() for t in base]
    before, bwd = SSD.ssd.launches, SSD.ssd_bwd.launches
    y, st = ssd(*ins[:5], chunk=chunk, initial_state=ins[5] if init else None)
    assert y.grad_fn is not None and st.grad_fn is not None
    assert SSD.ssd.launches == before + 1
    got = torch.autograd.grad((y, st), ins, (gy, gs))
    plain_ins = [t.clone().requires_grad_() for t in base]
    yr, sr = plain_ssd(*plain_ins[:5], chunk,
                       plain_ins[5] if init else None)
    want = torch.autograd.grad((yr, sr), plain_ins, (gy, gs))
    torch.cuda.synchronize()
    assert SSD.ssd.launches == before + 1
    assert SSD.ssd_bwd.launches == bwd + 1
    _grads_close(got, want, 3e-4)
    torch.testing.assert_close(y.detach(), yr.detach(), atol=3e-4, rtol=3e-4)
    with torch.no_grad():
        y0, s0 = ssd(*ins[:5], chunk=chunk,
                     initial_state=ins[5] if init else None)
    assert y0.grad_fn is None and s0.grad_fn is None
    assert SSD.ssd.launches == before + 2


def test_ssd_bwd_raises_on_unsupported_inputs(cuda):
    """The backward wrapper refuses what the kernel does not take, before
    any launch: a misaligned or strided dL/dy, a dL/dy of another type, a
    dL/d(state) of another shape, scratch of another shape."""
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 4, 32, 2, 16)
    y, st, cb, states = SSD.ssd(x, dt, A, B, C, chunk=64, keep_scratch=True)
    gy = torch.randn_like(x)
    ok = (x, dt, A, B, C, cb, states, st)
    before = SSD.ssd_bwd.launches
    off = torch.zeros(1 + gy.numel(), device=cuda)[1:].view(gy.shape)
    with pytest.raises(ValueError, match="aligned"):
        SSD.ssd_bwd(*ok, off, None, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        SSD.ssd_bwd(*ok, gy.transpose(1, 2).contiguous().transpose(1, 2),
                    None, chunk=64)
    with pytest.raises(ValueError):
        SSD.ssd_bwd(*ok, gy.bfloat16(), None, chunk=64)
    with pytest.raises(ValueError):
        SSD.ssd_bwd(*ok, gy, torch.zeros(1, 4, 16, 32, device=cuda), chunk=64)
    with pytest.raises(ValueError):
        SSD.ssd_bwd(x, dt, A, B, C, cb[:, :, :, :32], states, st, gy, None,
                    chunk=64)
    assert SSD.ssd_bwd.launches == before


def test_profile_session_on_cuda_writes_its_trace(cuda, tmp_path):
    """A ProfileSession over CUDA steps: each measured call waits for the
    card, and the torch.profiler trace it writes holds the card's
    kernels (a window of 2 calls after the warm-up call)."""
    import json

    from repro_torch.obs import ProfileSession

    a = torch.randn((1024, 1024), device=cuda)
    prof = ProfileSession(logdir=str(tmp_path), trace_calls=2)
    with prof:
        for _ in range(4):
            out = prof.step("matmul", 1e-6, lambda: {"y": a @ a})
    assert out["y"].is_cuda
    assert [bool(r.attrs.get("traced")) for r in prof.records] == \
        [False, True, True, False]
    assert all(r.measured_s > 0 for r in prof.records)
    events = json.load(open(prof.trace_path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no kernel of the card"
    dev = [e for e in prof.profiler.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.self_device_time_total for e in dev) > 0


def test_update_of_one_clients_bf16_rows_matches_plain(cuda):
    """The local step's update: one launch on client 1's rows (views) of
    stacked bf16 leaves with float32 moments, bit-equal to the plain
    version; client 0's rows untouched."""
    g = torch.Generator(device=cuda).manual_seed(5)
    shapes = [(2, 3, 96, 40), (2, 64), (2, 5)]
    P = [torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
         for s in shapes]
    M = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    G = [torch.randn(s[1:], generator=g, device=cuda).to(torch.bfloat16)
         for s in shapes]
    P0, M0 = [p.clone() for p in P], [m.clone() for m in M]
    want_p, want_m = tree_sgd_update_ref([p[1] for p in P],
                                         [m[1] for m in M], G, eta=0.05,
                                         beta=0.9, wd=1e-4)
    before = fused_sgd_update.launches
    tree_sgd_update_([p[1] for p in P], [m[1] for m in M], G, eta=0.05,
                     beta=0.9, wd=1e-4)
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 1
    for p, m, p0, m0, wp, wm in zip(P, M, P0, M0, want_p, want_m):
        assert torch.equal(p[0], p0[0]) and torch.equal(m[0], m0[0])
        # float32 math rounded once to bf16, in the plain version's order
        assert torch.equal(p[1], wp) and torch.equal(m[1], wm)


@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
def test_update_of_bf16_rows_with_float32_grads_matches_plain(cuda, m_dtype):
    """The microbatch step's update: bf16 parameters with a float32
    (accumulated) gradient, read as float32 by one launch, bit-equal to
    the plain version; a leaf at an odd offset takes the scalar loop."""
    g = torch.Generator(device=cuda).manual_seed(6)
    shapes = [(2, 3, 96, 40), (2, 64), (2, 5)]
    P = [torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
         for s in shapes]
    M = [torch.randn(s, generator=g, device=cuda).to(m_dtype)
         for s in shapes]
    G = [torch.randn(s[1:], generator=g, device=cuda) * 1e-2
         for s in shapes]
    G[1] = torch.empty(65, device=cuda)[1:].copy_(G[1])
    assert G[1].data_ptr() % 16
    want_p, want_m = tree_sgd_update_ref([p[0] for p in P],
                                         [m[0] for m in M], G, eta=0.05,
                                         beta=0.9, wd=1e-4)
    before = fused_sgd_update.launches
    tree_sgd_update_([p[0] for p in P], [m[0] for m in M], G, eta=0.05,
                     beta=0.9, wd=1e-4)
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 1
    for p, m, wp, wm in zip(P, M, want_p, want_m):
        assert torch.equal(p[0], wp) and torch.equal(m[0], wm)


# -- MoE, MLA and the int8 KV cache (the card against the CPU route) --------

@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_layer_routes_equal_on_the_card(cuda, arch, capacity_factor):
    """The SMOKE MoE layer in float32, 3 rows of 40 tokens: the same
    assignment (experts, ranks, kept) on both devices, the output within
    1e-5 and aux within 1e-6; the inputs' smallest top-k margin (1e-4)
    far above the router's float32 rounding."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MOE

    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = MOE.init_moe(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        3, 40, cfg.d_model).astype(np.float32))
    on = {k: (v.to(cuda) if isinstance(v, torch.Tensor)
              else {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in params.items()}
    rc, rg = MOE.route(params, cfg.moe, x), MOE.route(on, cfg.moe, x.to(cuda))
    top = torch.topk(torch.softmax(x @ params["w_router"], dim=-1),
                     cfg.moe.top_k + 1, dim=-1).values
    assert float((top[..., -2] - top[..., -1]).min()) > 1e-4
    for name in ("idx", "rank", "keep"):
        assert torch.equal(getattr(rg, name).cpu(), getattr(rc, name))
    assert bool((~rc.keep).any()) == (capacity_factor is not None)
    yc, ac = MOE.apply_moe(params, cfg, x)
    yg, ag = MOE.apply_moe(on, cfg, x.to(cuda))
    torch.testing.assert_close(yg.cpu(), yc, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ag.cpu(), ac, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dqk,dv", [(2, 300, 8, 96, 64),
                                          (1, 257, 4, 192, 128)])
def test_padded_mla_flash_matches_plain(cuda, dtype, B, S, H, dqk, dv):
    """minicpm3's (96/64 → 128) and deepseek's (192/128 → 256) head dims
    through the zero-padded kernel call against the plain attention on
    the unpadded dims: float32 within 1e-5, bfloat16 within ref.py's
    tolerance."""
    from repro_torch.models import attention as TA

    g = torch.Generator(device=cuda).manual_seed(3)
    q, k = (torch.randn(B, S, H, dqk, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=g, device=cuda).to(dtype)
    scale = 1.0 / math.sqrt(dqk)
    before = FA.flash_attention.launches
    out = TA._padded_flash(q, k, v, TA.HEAD_DIMS[1 if dqk <= 128 else 2],
                           window=None, softcap=None, scale=scale)
    assert FA.flash_attention.launches == before + 1
    assert out.shape == (B, S, H, dv) and out.dtype == dtype
    pos = torch.arange(S, device=cuda)
    ref = TA.attend(q.float(), k.float(), v.float(),
                    TA._mask_bias(pos, pos, None), None, scale)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        _, elem, row = bf16_mismatch(out, ref)
        assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_codes_equal_across_routes(cuda, dtype):
    from repro_torch.models import attention as TA

    x = (torch.randn(4, 33, 8, 128, generator=torch.Generator()
                     .manual_seed(4)) * 3.0).to(dtype)
    x[0, 0, 0] = 0.0
    qc, sc = TA._quant(x)
    qg, sg = TA._quant(x.to(cuda))
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    assert torch.equal(TA._dequant(qg, sg, dtype).cpu(),
                       TA._dequant(qc, sc, dtype))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "internvl2-2b"])
def test_rglru_and_frontend_smoke_logits_equal_cpu(cuda, arch):
    """SMOKE in float32 from one set of params: recurrentgemma-2b with an
    80-token prompt (past its 64-token window), internvl2-2b with 16 patch
    embeddings and a 24-token prompt; then 8 decode steps fed the CPU run's
    tokens. The card's logits within 1e-4 of the CPU's (float32 on both
    sides, sums in another order); one flash launch an attention layer a
    prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF
    from repro_torch.utils.tree import tree_map

    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    p_cpu = TF.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    n = 80 if cfg.frontend is None else 24
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, n))).long()
    fe = (None if cfg.frontend is None else torch.from_numpy(rng.randn(
        1, cfg.n_frontend_tokens, cfg.frontend_dim).astype(np.float32)))
    runs, toks = {}, []
    for dev in ("cpu", cuda):
        params = p_cpu if dev == "cpu" else tree_map(lambda t: t.to(dev),
                                                     p_cpu)
        cache = TF.init_cache(cfg, 1, n + 32, device=dev)
        before = FA.flash_attention.launches
        logits, cache = TF.prefill(
            params, cfg, prompt.to(dev), cache,
            None if fe is None else fe.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            attn = sum(k in "GL" for k in cfg.layer_kinds())
            assert FA.flash_attention.launches == before + attn
        steps = [logits[:, -1].cpu()]
        for i in range(8):
            if dev == "cpu":
                toks.append(torch.argmax(steps[-1], dim=-1)[:, None])
            logits, cache = TF.decode_step(params, cfg, toks[i].to(dev),
                                           cache)
            steps.append(logits[:, -1].cpu())
        runs[str(dev)] = torch.stack(steps)
    err = float((runs["cpu"] - runs[str(cuda)]).abs().max())
    assert err <= 1e-4, err


def test_update_of_a_recurrentgemma_client_tree_is_two_launches(cuda):
    """recurrentgemma-2b SMOKE in bf16, 2 clients: one client's update of
    its row views (bf16 leaves and the float32 a_param rows, two type
    groups, so two launches) bit-equal to the plain version; the other
    client's rows untouched."""
    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd as LS
    from repro_torch.utils.tree import tree_leaves

    cfg = get_arch("recurrentgemma-2b", smoke=True)
    state = LS.init_state(0, cfg, 2, device=cuda)
    P = tree_leaves(state["params"])
    g = torch.Generator(device=cuda).manual_seed(3)
    M = [torch.randn(p.shape, generator=g, device=cuda) for p in P]
    G = [torch.randn(p.shape[1:], generator=g, device=cuda).to(p.dtype)
         for p in P]
    assert {p.dtype for p in P} == {torch.bfloat16, torch.float32}
    P0, M0 = [p.clone() for p in P], [m.clone() for m in M]
    want_p, want_m = tree_sgd_update_ref([p[1] for p in P],
                                         [m[1] for m in M], G, eta=0.05,
                                         beta=0.9, wd=1e-4)
    before = fused_sgd_update.launches
    tree_sgd_update_([p[1] for p in P], [m[1] for m in M], G, eta=0.05,
                     beta=0.9, wd=1e-4)
    torch.cuda.synchronize()
    assert fused_sgd_update.launches == before + 2
    for p, m, p0, m0, wp, wm in zip(P, M, P0, M0, want_p, want_m):
        assert torch.equal(p[0], p0[0]) and torch.equal(m[0], m0[0])
        assert torch.equal(p[1], wp) and torch.equal(m[1], wm)


# ---------------------------------------------------------------------------
# The profiler ranges of a training step, and the round's device time
# ---------------------------------------------------------------------------

def _kernels_under(prof, names):
    """Kernels a range holds: those launched by a host op that started
    inside one of the range's host spans (as ``bench/trace.py`` charges
    them)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    op_start = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda}
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.device_type() != cuda and e.name() in names]
    launched = [op_start.get(e.linked_correlation_id()) for e in events
                if e.device_type() == cuda and not e.is_user_annotation()]
    return {n: sum(1 for t in launched if t is not None and any(
        n == m and a <= t <= b for m, a, b in spans)) for n in names}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "musicgen-medium"])
def test_layer_ranges_of_a_step_on_the_card(cuda, arch):
    """A SMOKE step on the card opens each range as on the CPU, the
    backward's (the remat recompute, the plain backward) on the autograd
    engine's device thread, and every range but the feed's and the loss
    read's holds kernels."""
    from range_cases import expected_counts, host_ranges, smoke_run
    from torch.profiler import ProfilerActivity, profile

    want = expected_counts(arch)
    smoke_run(arch, cuda)      # builds and warms the kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        smoke_run(arch, cuda)
        torch.cuda.synchronize()
    got = host_ranges(prof, set(want))
    assert {n: sum(1 for g in got if g[0] == n) for n in want} == want
    held = _kernels_under(prof, set(want) - {"driver.batch",
                                             "driver.loss_read",
                                             "engine.run", "engine.stage"})
    assert all(held.values()), held


def test_driver_round_span_gets_its_device_time_on_the_card(cuda):
    """Under a Tracer each ``reduce`` span carries the round's device ms
    from a CUDA event pair; its wall length is the enqueue."""
    from range_cases import smoke_run

    from repro_torch.obs.trace import WALL, Tracer

    tr = Tracer()
    smoke_run("mamba2-2.7b", cuda, tracer=tr, k=1)
    rounds = tr.find("reduce", clock=WALL)
    assert len(rounds) == 2
    assert all(r.attrs["device_ms"] > 0 for r in rounds), rounds


def test_traced_driver_fingerprint_is_the_same_on_the_card(cuda):
    """Two traced runs on the card: their rounds' ``device_ms`` are
    measured and may differ, their span trees' fingerprints agree."""
    from range_cases import smoke_run

    from repro_torch.obs.trace import WALL, Tracer

    runs = [Tracer(), Tracer()]
    for tr in runs:
        smoke_run("mamba2-2.7b", cuda, tracer=tr, k=1)
    for tr in runs:
        assert all(r.attrs["device_ms"] > 0
                   for r in tr.find("reduce", clock=WALL))
    assert runs[0].tree_keys() == runs[1].tree_keys()
