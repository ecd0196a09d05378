"""Launchers of the Hopper quantize kernels (``csrc/quantize.cu``).

``quantize_kernel`` replaces the Pallas TPU kernel
``src/repro/kernels/quantize/kernel.py:65`` and covers a whole (N, M) block
of client deltas, one scale per row, in one launch (the TPU path launched
once per client). Bound: 9 bytes per element (float32 in, uint32 bits in,
int8 out) over 3.35 TB/s.

``dequant_mean_kernel`` replaces ``src/repro/kernels/quantize/kernel.py:98``:
each thread sums the N clients of 4 adjacent columns in order in float32,
one 4-byte load per client row, 32 rows in flight, with no (N, M) float32
intermediate and no atomics. Bound: 1 byte
per code in plus 4 bytes per column out, over 3.35 TB/s.

The TPU path's (32, 128) int8 tile check has no counterpart: the CUDA
kernels index elements directly and take any M.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library


def _qmax(bits: int) -> float:
    if not 2 <= bits <= 8:
        raise ValueError(f"quantize: bits must be in [2, 8], got {bits}")
    return float(2 ** (bits - 1) - 1)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def check_quantize_inputs(y, rand_bits, scales):
    _require(y.dim() == 2, f"quantize: y must be (N, M), got {tuple(y.shape)}")
    _require(y.dtype == torch.float32, f"quantize: y must be float32, "
                                       f"got {y.dtype}")
    _require(rand_bits.dtype == torch.int32,
             f"quantize: rand_bits must be int32, got {rand_bits.dtype}")
    _require(rand_bits.shape == y.shape,
             f"quantize: rand_bits shape {tuple(rand_bits.shape)} != y "
             f"{tuple(y.shape)}")
    _require(scales.dtype == torch.float32 and scales.shape == y.shape[:1],
             f"quantize: scales must be float32 ({y.shape[0]},), got "
             f"{scales.dtype} {tuple(scales.shape)}")
    _require(y.numel() > 0, "quantize: empty input")
    for name, t in (("y", y), ("rand_bits", rand_bits), ("scales", scales)):
        _require(t.device == y.device,
                 f"quantize: {name} on {t.device}, y on {y.device}")
        _require(t.is_contiguous(), f"quantize: {name} is not contiguous")


def check_dequant_inputs(q, scales):
    _require(q.dim() == 2, f"dequant_mean: q must be (N, M), got "
                           f"{tuple(q.shape)}")
    _require(q.dtype == torch.int8, f"dequant_mean: q must be int8, "
                                    f"got {q.dtype}")
    _require(scales.dtype == torch.float32 and scales.shape == q.shape[:1],
             f"dequant_mean: scales must be float32 ({q.shape[0]},), got "
             f"{scales.dtype} {tuple(scales.shape)}")
    _require(q.numel() > 0, "dequant_mean: empty input")
    for name, t in (("q", q), ("scales", scales)):
        _require(t.device == q.device,
                 f"dequant_mean: {name} on {t.device}, q on {q.device}")
        _require(t.is_contiguous(), f"dequant_mean: {name} is not contiguous")


def quantize_kernel(y, rand_bits, scales, *, bits: int = 8):
    """y: float32 (N, M); rand_bits: int32 (N, M), read as uint32; scales:
    float32 (N,). Returns int8 codes (N, M). CUDA tensors only."""
    qmax = _qmax(bits)
    check_quantize_inputs(y, rand_bits, scales)
    _require(y.device.type == "cuda",
             f"quantize_kernel: takes CUDA tensors, got {y.device}")
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    lib = library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        status = lib.repro_quantize(y.data_ptr(), rand_bits.data_ptr(),
                                    scales.data_ptr(), q.data_ptr(),
                                    y.shape[0], y.shape[1], qmax, stream)
    quantize_kernel.launches += 1
    check(status, "quantize_kernel")
    return q


def dequant_mean_kernel(q, scales, *, bits: int = 8):
    """q: int8 (N, M); scales: float32 (N,). Returns the float32 mean (M,).
    CUDA tensors only."""
    qmax = _qmax(bits)
    check_dequant_inputs(q, scales)
    _require(q.device.type == "cuda",
             f"dequant_mean_kernel: takes CUDA tensors, got {q.device}")
    n, cols = q.shape
    out = torch.empty((cols,), dtype=torch.float32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_dequant_mean(q.data_ptr(), scales.data_ptr(),
                                        out.data_ptr(), n, cols, qmax,
                                        1.0 / n, stream)
    dequant_mean_kernel.launches += 1
    check(status, "dequant_mean_kernel")
    return out


quantize_kernel.launches = 0
dequant_mean_kernel.launches = 0
