"""Launcher of the Hopper fused momentum-SGD kernel (``csrc/fused_update.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_update/kernel.py:33``
(``fused_sgd_update``). The kernel is memory-bound: 20 bytes per float32
element (3 reads, 2 writes), so its bound on an H100 SXM is bytes ÷
3.35 TB/s; the simulator's leaves are small enough that one launch costs
more than that bound. One launch covers a whole stacked (N, …) leaf.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(p, m, g):
    """Raise on anything the kernel does not take."""
    for name, t in (("p", p), ("m", m), ("g", g)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_sgd_update: {name} must be a tensor")
        if t.device != p.device:
            raise ValueError(f"fused_sgd_update: {name} is on {t.device}, "
                             f"p on {p.device}")
        if t.shape != p.shape:
            raise ValueError(f"fused_sgd_update: {name} has shape "
                             f"{tuple(t.shape)}, p {tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_sgd_update: {name} is not contiguous")
    if p.dtype not in _DTYPE_CODE or m.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_sgd_update: p/m must be float32 or bfloat16, "
                        f"got {p.dtype}/{m.dtype}")
    if g.dtype != p.dtype:
        raise TypeError(f"fused_sgd_update: g must have p's dtype {p.dtype}, "
                        f"got {g.dtype}")
    if p.numel() == 0:
        raise ValueError("fused_sgd_update: empty tensors")


def fused_sgd_update(p, m, g, *, eta: float, beta: float = 0.0,
                     wd: float = 0.0):
    """In place: p ← p − η·(β·m + g + wd·p), m ← β·m + g + wd·p.

    CUDA tensors of one shape, float32 or bfloat16 p and m (g of p's type),
    contiguous. Returns (p, m), the same tensors, updated.
    """
    check_inputs(p, m, g)
    if p.device.type != "cuda":
        raise ValueError(f"fused_sgd_update: the kernel takes CUDA tensors, "
                         f"got {p.device}")
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        status = lib.repro_fused_sgd_update(
            p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel(),
            _DTYPE_CODE[p.dtype], _DTYPE_CODE[m.dtype], float(eta),
            float(beta), float(wd), stream)
    fused_sgd_update.launches += 1
    check(status, "fused_sgd_update")
    return p, m


fused_sgd_update.launches = 0
