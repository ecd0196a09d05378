"""Launchers of the Hopper quantize kernels (``csrc/quantize.cu``).

``quantize_kernel`` replaces the Pallas TPU kernel
``src/repro/kernels/quantize/kernel.py:65`` and covers a whole (N, M) block
of client deltas, one scale per row, in one launch (the TPU path launched
once per client): a 2-D grid of rows and column tiles of 1,024, 8
elements a thread in 16-byte loads where the rows are 16-byte aligned,
single elements where they are not. Bound: 9 bytes per element (float32 in,
uint32 bits in, int8 out) over 3.35 TB/s.

``dequant_mean_kernel`` replaces ``src/repro/kernels/quantize/kernel.py:98``:
each thread sums the N clients of 4 adjacent columns in order in float32,
one 4-byte load per client row, 32 rows in flight, with no (N, M) float32
intermediate and no atomics. Bound: 1 byte
per code in plus 4 bytes per column out, over 3.35 TB/s.

The TPU path's (32, 128) int8 tile check has no counterpart: the CUDA
kernels index elements directly and take any M (quantize's launcher
refuses rows of more than 2^31 − 1,025 columns: its column offsets are
32-bit).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import trace
from repro_torch.kernels.build import check, library
from repro_torch.kernels.trace import is_fake


def _qmax(bits: int) -> float:
    if not 2 <= bits <= 8:
        raise ValueError(f"quantize: bits must be in [2, 8], got {bits}")
    return float(2 ** (bits - 1) - 1)


def check_quantize_inputs(y, rand_bits, scales):
    # each message is formatted only when its check fails: the wrapper
    # runs once per leaf per round
    if y.dim() != 2:
        raise ValueError(f"quantize: y must be (N, M), got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise ValueError(f"quantize: y must be float32, got {y.dtype}")
    if rand_bits.dtype != torch.int32:
        raise ValueError(f"quantize: rand_bits must be int32, got "
                         f"{rand_bits.dtype}")
    if rand_bits.shape != y.shape:
        raise ValueError(f"quantize: rand_bits shape "
                         f"{tuple(rand_bits.shape)} != y {tuple(y.shape)}")
    if scales.dtype != torch.float32 or scales.shape != y.shape[:1]:
        raise ValueError(f"quantize: scales must be float32 "
                         f"({y.shape[0]},), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if y.numel() == 0:
        raise ValueError("quantize: empty input")
    for name, t in (("y", y), ("rand_bits", rand_bits), ("scales", scales)):
        if t.device != y.device:
            raise ValueError(f"quantize: {name} on {t.device}, y on "
                             f"{y.device}")
        if not t.is_contiguous():
            raise ValueError(f"quantize: {name} is not contiguous")


def check_dequant_inputs(q, scales):
    if q.dim() != 2:
        raise ValueError(f"dequant_mean: q must be (N, M), got "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"dequant_mean: q must be int8, got {q.dtype}")
    if scales.dtype != torch.float32 or scales.shape != q.shape[:1]:
        raise ValueError(f"dequant_mean: scales must be float32 "
                         f"({q.shape[0]},), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if q.numel() == 0:
        raise ValueError("dequant_mean: empty input")
    for name, t in (("q", q), ("scales", scales)):
        if t.device != q.device:
            raise ValueError(f"dequant_mean: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_mean: {name} is not contiguous")


def _require_cuda(t, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors, got {t.device}")


def _launch(t, fn, *args):
    """Call the C launcher ``fn(*args, stream)`` on ``t``'s device and its
    current stream; the device is switched only when ``t`` is not on the
    current one."""
    if t.device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def quantize_kernel(y, rand_bits, scales, *, bits: int = 8):
    """y: float32 (N, M); rand_bits: int32 (N, M), read as uint32; scales:
    float32 (N,). Returns int8 codes (N, M). CUDA tensors only."""
    qmax = _qmax(bits)
    check_quantize_inputs(y, rand_bits, scales)
    if is_fake(y):   # a traced call: the op's shapes, nothing launched
        return trace.quantize_op(y, rand_bits, scales, bits)
    _require_cuda(y, "quantize_kernel")
    n, cols = y.shape
    q = torch.empty((n, cols), dtype=torch.int8, device=y.device)
    status = _launch(y, library().repro_quantize, y.data_ptr(),
                     rand_bits.data_ptr(), scales.data_ptr(), q.data_ptr(),
                     n, cols, qmax)
    quantize_kernel.launches += 1
    check(status, "quantize_kernel")
    return q


def dequant_mean_kernel(q, scales, *, bits: int = 8):
    """q: int8 (N, M); scales: float32 (N,). Returns the float32 mean (M,).
    CUDA tensors only."""
    qmax = _qmax(bits)
    check_dequant_inputs(q, scales)
    if is_fake(q):
        return trace.dequant_mean_op(q, scales, bits)
    _require_cuda(q, "dequant_mean_kernel")
    n, cols = q.shape
    out = torch.empty((cols,), dtype=torch.float32, device=q.device)
    status = _launch(q, library().repro_dequant_mean, q.data_ptr(),
                     scales.data_ptr(), out.data_ptr(), n, cols, qmax,
                     1.0 / n)
    dequant_mean_kernel.launches += 1
    check(status, "dequant_mean_kernel")
    return out


quantize_kernel.launches = 0
dequant_mean_kernel.launches = 0
