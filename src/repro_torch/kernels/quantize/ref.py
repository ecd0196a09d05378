"""Plain PyTorch versions of the communication-compression kernels.

``quantize_ref``: symmetric linear quantization to ``bits``-bit signed codes
with stochastic rounding — the client half of a compressed round:

    qmax = 2^(bits-1) - 1
    y    = x / scale * qmax
    q    = clip(floor(y + u), -qmax, qmax)        u = bits · 2^-32

``dequant_mean_ref``: the server half — dequantize N client messages and
average them:

    mean = (1/N) Σ_i q_i · (scale_i / qmax)

The same op order as the JAX package's ``quantize/ref.py`` and as
``csrc/quantize.cu``, so given the same random bits the int8 codes are
equal. The random words arrive as int32 and are read as uint32.
"""
from __future__ import annotations

import torch

_INV_2_32 = 1.0 / 4294967296.0  # uint32 bits -> U[0,1)


def qmax_for(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def uniform_from_bits(rand_bits):
    """int32 words read as uint32, to float32, times 2^-32 (words at or
    above 2^32 − 128 round to u = 1.0, as on the reference)."""
    u32 = rand_bits.to(torch.int64) & 0xFFFFFFFF
    return u32.to(torch.float32) * _INV_2_32


def quantize_ref(x, rand_bits, scale, *, bits: int = 8):
    """x: float32; rand_bits: int32 of x's shape; scale: float32 that
    broadcasts against x (a scalar, or (N, 1) per-row scales, > 0).

    Returns int8 codes in [-qmax, qmax].
    """
    qmax = qmax_for(bits)
    y = x.to(torch.float32) / scale * qmax
    q = torch.floor(y + uniform_from_bits(rand_bits))
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequant_mean_ref(q, scales, *, bits: int = 8):
    """q: (N, ...) int8 codes; scales: (N,) float32. Returns the float32
    mean, of q[0]'s shape."""
    qmax = qmax_for(bits)
    n = q.shape[0]
    w = (scales.to(torch.float32) / qmax).reshape((n,) + (1,) * (q.dim() - 1))
    return torch.sum(q.to(torch.float32) * w, dim=0) * (1.0 / n)
