"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips at run time where there is no CUDA card
(the Hopper kernels have no CPU mode). This file imports no JAX, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as the CPU parity tests state them: the fused update 1e-6 in
float32 and 1e-2 in bfloat16, quantize codes exactly equal, dequant_mean
1e-6. Flash attention: 1e-5 in float32 (the kernel sums the same float32
products in another order); in bfloat16 the tolerance of
``kernels/flash_attention/ref.py`` (elementwise 5e-3 + 1e-2 |ref|, each
query row of each head within 1e-2 of its norm).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     bf16_mismatch)
from repro_torch.kernels.fused_update.kernel import fused_sgd_update
from repro_torch.kernels.fused_update.ref import sgd_update_ref
from repro_torch.kernels.quantize import ops as TQ
from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)
from repro_torch.kernels.quantize.ref import dequant_mean_ref, quantize_ref

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


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(32, 784), (32, 1), (3, 70001)])
def test_quantize_and_dequant_match_plain(cuda, shape, bits):
    g = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randn(shape, generator=g, device=cuda) \
        * torch.rand((shape[0], 1), generator=g, device=cuda)
    rb = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                       generator=g, device=cuda)
    rb[0, :1] = -1                      # 2^32 - 1: u rounds to 1.0
    s = TQ.compute_scale(y, dim=1)
    q = quantize_kernel(y, rb, s, bits=bits)
    assert torch.equal(q, quantize_ref(y, rb, s[:, None], bits=bits))
    mean = dequant_mean_kernel(q, s, bits=bits)
    torch.testing.assert_close(mean, dequant_mean_ref(q, s, bits=bits),
                               atol=1e-6, rtol=1e-6)
    deq, mean2 = TQ.decode_mean_leaf(q, s, bits=bits)
    assert torch.equal(mean2, mean) and deq.shape == shape


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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, KV, D, causal, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dtype)
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


def test_flash_attention_raises_on_unsupported_cuda_inputs(cuda):
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
    assert counts["fused_sgd_update"] == 8 * 48       # 8 leaves x 48 steps
    assert counts["quantize_kernel"] == counts["dequant_mean_kernel"] == 8 * 8
    vals = np.array([r.value for r in hist])
    assert np.isfinite(vals).all() and vals[-1] < 0.9 * vals[0]
