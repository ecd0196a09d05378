"""Quantize entry points: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernels in ``kernel.py`` (or the
call raises); a CPU tensor goes through the plain versions in ``ref.py``.
There is no other route and no fallback.

The per-leaf pair ``encode_leaf`` / ``decode_mean_leaf`` is the unit a
compressed round (and the streaming per-leaf round) drives, one leaf at
a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import ref as R
from repro_torch.kernels.trace import is_fake
from repro_torch.kernels.quantize.kernel import (
    check_dequant_inputs,
    check_quantize_inputs,
    dequant_mean_kernel,
    quantize_kernel,
)

qmax_for = R.qmax_for


def _route(t) -> str:
    if is_fake(t):   # a trace: the kernels' ops
        return "cuda"
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quantize ops: no route for device {t.device}")
    return t.device.type


def compute_scale(x, *, dim=None, eps: float = 1e-12):
    """Symmetric scale max|x|, floored away from zero: one for the whole
    tensor, or one per slice along ``dim`` (a compressed round takes one
    per client row of its (N, M) block, ``dim=1``)."""
    a = torch.abs(x.to(torch.float32))
    return torch.clamp_min(a.max() if dim is None else a.amax(dim=dim), eps)


def encode_leaf(y, rand_bits, scales, *, bits: int = 8):
    """Client half of one leaf's round: SR-quantize an (N, M) delta block.

    ``y``: float32 (N, M) per-client deltas (flattened leaf); ``rand_bits``:
    int32 (N, M), read as uint32; ``scales``: float32 (N,) per-client
    symmetric scales. Returns int8 codes of ``y``'s shape.
    """
    if _route(y) == "cuda":
        return quantize_kernel(y, rand_bits, scales, bits=bits)
    check_quantize_inputs(y, rand_bits, scales)
    return R.quantize_ref(y, rand_bits, scales[:, None], bits=bits)


def quantize(x, rand_bits, scale, *, bits: int = 8):
    """Stochastic-rounding quantize one leaf (any shape) with one scalar
    scale to int8 codes of x's shape."""
    y = x.to(torch.float32).reshape(1, -1).contiguous()
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=x.device).reshape(1)
    return encode_leaf(y, rand_bits.reshape(1, -1).contiguous(), s,
                       bits=bits).reshape(x.shape)


def dequant_mean(q, scales, *, bits: int = 8):
    """Fused dequantize + average of N stacked client messages: q (N, ...)
    int8, scales (N,) float32 -> float32 mean of q[0]'s shape."""
    q2 = q.reshape(q.shape[0], -1)
    if _route(q) == "cuda":
        mean = dequant_mean_kernel(q2, scales, bits=bits)
    else:
        check_dequant_inputs(q2, scales)
        mean = R.dequant_mean_ref(q2, scales, bits=bits)
    return mean.reshape(q.shape[1:])


def decode_mean_leaf(q, scales, *, bits: int = 8):
    """Server half of one leaf's round: fused dequantize + mean.

    ``q``: int8 (N, M) codes; ``scales``: float32 (N,). Returns
    ``(deq, mean)`` — each client's dequantized float32 message (N, M),
    needed for the error-feedback residual, and their average (M,).
    """
    qmax = R.qmax_for(bits)
    mean = dequant_mean(q, scales, bits=bits)
    deq = q.to(torch.float32) * (scales[:, None] / qmax)
    return deq, mean
