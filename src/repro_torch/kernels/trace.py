"""The kernels as ``torch.library`` ops, for tracing on fake tensors.

The dry run (``launch/dryrun.py``) traces the card's route under
``FakeTensorMode``, where a kernel wrapper must not call its CUDA
launcher. So each kernel is also an op in the ``repro_torch`` namespace:
its implementation is the launcher, its fake implementation gives the
outputs' shapes and types, and its FLOP formula — the count
``chip_smoke.py`` bounds the kernel by — is registered with
``torch.utils.flop_counter``. A launcher handed a fake tensor calls the op
instead of launching (``is_fake``): nothing runs and no launch is
counted, and the plain version never stands in for the kernel in a trace.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def masked_pairs(S: int, window, kind: str) -> float:
    """Masked (q,k) pair count per sequence for one layer (the JAX
    package's ``launch/flops._attn_pairs``; ``launch.flops`` prices with
    it too)."""
    if kind == "decode":
        return float(min(S, window) if window else S)
    if window and window < S:
        return float(window) * S - window * (window - 1) / 2.0
    return S * (S + 1) / 2.0


def attn_pairs(Sq: int, Sk: int, causal: bool, window) -> float:
    """Visible (query, key) pairs of one head: the queries sit at the last
    Sq of Sk positions and see the keys at or before them, the last
    ``window`` of them with a window."""
    if not causal:
        return float(Sq * Sk)
    return (masked_pairs(Sk, window, "prefill")
            - masked_pairs(Sk - Sq, window, "prefill"))


def ssd_flops(b, S, H, P, G, N, chunk, init=False) -> float:
    """The SSD scan's FLOPs (``chip_smoke.ssd_work``): per chunk of q rows
    C·Bᵀ over the lower triangle once per group, the intra-chunk product
    per head, the state term of y (from an entering state) and the state
    update; 2 FLOPs a multiply-add."""
    Q = min(chunk, S)
    flops = 0.0
    for c in range(-(-S // Q)):
        q = min(Q, S - c * Q)
        tri = q * (q + 1) / 2
        flops += 2.0 * b * (G * tri * N + H * tri * P
                            + (H * q * N * P if c or init else 0)
                            + H * q * P * N)
    return flops


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int, softcap: float, scale: float) -> Tensor:
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    return flash_attention(q, k, v, causal=causal, window=window or None,
                           softcap=softcap or None, scale=scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs):
    B, Sq, H, D = q_shape
    return int(4 * B * H * D * attn_pairs(Sq, k_shape[1], causal,
                                          window or None))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd", mutates_args=())
def ssd_op(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
           chunk: int, initial_state: Optional[Tensor]) -> List[Tensor]:
    from repro_torch.kernels.ssd.kernel import ssd

    return list(ssd(x, dt, A, B, C, chunk=chunk,
                    initial_state=initial_state))


@ssd_op.register_fake
def _(x, dt, A, B, C, chunk, initial_state):
    b, _, H, P = x.shape
    return [torch.empty_like(x),
            x.new_empty((b, H, P, B.shape[3]), dtype=torch.float32)]


@register_flop_formula(torch.ops.repro_torch.ssd)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, init_shape,
      *args, **kwargs):
    b, S, H, P = x_shape
    return int(ssd_flops(b, S, H, P, B_shape[2], B_shape[3], chunk,
                         init_shape is not None))


# ---------------------------------------------------------------------------
# fused momentum-SGD update
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::fused_sgd_update_",
                         mutates_args=("ps", "ms"))
def fused_sgd_update_op(ps: List[Tensor], ms: List[Tensor],
                        gs: List[Tensor], eta: float, beta: float,
                        wd: float) -> None:
    from repro_torch.kernels.fused_update.kernel import \
        fused_sgd_update_leaves

    fused_sgd_update_leaves(ps, ms, gs, eta=eta, beta=beta, wd=wd)


@fused_sgd_update_op.register_fake
def _(ps, ms, gs, eta, beta, wd):
    return None


@register_flop_formula(torch.ops.repro_torch.fused_sgd_update_)
def _(ps_shapes, *args, **kwargs):
    return 4 * sum(math.prod(s) for s in ps_shapes)


# ---------------------------------------------------------------------------
# quantize / dequant_mean
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::quantize", mutates_args=())
def quantize_op(y: Tensor, rand_bits: Tensor, scales: Tensor,
                bits: int) -> Tensor:
    from repro_torch.kernels.quantize.kernel import quantize_kernel

    return quantize_kernel(y, rand_bits, scales, bits=bits)


@quantize_op.register_fake
def _(y, rand_bits, scales, bits):
    return torch.empty_like(y, dtype=torch.int8)


@register_flop_formula(torch.ops.repro_torch.quantize)
def _(y_shape, *args, **kwargs):
    return 6 * y_shape[0] * y_shape[1]


@torch.library.custom_op("repro_torch::dequant_mean", mutates_args=())
def dequant_mean_op(q: Tensor, scales: Tensor, bits: int) -> Tensor:
    from repro_torch.kernels.quantize.kernel import dequant_mean_kernel

    return dequant_mean_kernel(q, scales, bits=bits)


@dequant_mean_op.register_fake
def _(q, scales, bits):
    return q.new_empty((q.shape[1],), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.dequant_mean)
def _(q_shape, *args, **kwargs):
    return 2 * q_shape[0] * q_shape[1] + q_shape[0]
