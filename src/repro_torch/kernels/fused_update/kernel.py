"""Launcher of the Hopper fused momentum-SGD kernel (``csrc/fused_update.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_update/kernel.py:33``
(``fused_sgd_update``). The kernel is memory-bound: 20 bytes per float32
element (3 reads, 2 writes), so its bound on an H100 SXM is bytes ÷
3.35 TB/s, summed over the leaves of a launch. One launch covers a table of
up to ``MAX_LEAVES`` stacked (N, …) leaves of one (p type, m type, g type)
triple:
the simulator's local step updates its whole tree in one launch, since at
its shapes a launch costs more than the bytes. The table goes to the
kernel by value, as a kernel parameter: no device allocation, no copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import trace
from repro_torch.kernels.build import check, library
from repro_torch.kernels.trace import is_fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 64   # the kernel's leaf table; a longer list takes more launches


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
    if g.dtype != p.dtype and not (p.dtype == torch.bfloat16
                                   and g.dtype == torch.float32):
        raise TypeError(f"fused_sgd_update: g must have p's dtype {p.dtype} "
                        f"(or be float32 with a bfloat16 p), got {g.dtype}")
    if p.numel() == 0:
        raise ValueError("fused_sgd_update: empty tensors")


def fused_sgd_update_leaves(ps, ms, gs, *, eta: float, beta: float = 0.0,
                            wd: float = 0.0):
    """In place on every leaf: p ← p − η·(β·m + g + wd·p), m ← β·m + g +
    wd·p.

    ``ps``, ``ms``, ``gs``: equal-length sequences of CUDA tensors, each
    (p, m, g) of one shape, float32 or bfloat16 p and m,
    contiguous; any alignment. g is of p's type, or float32 with a
    bfloat16 p (a float32 accumulated gradient, read as it is). Every leaf
    is checked before anything launches. One launch per (p type, m type,
    g type, device) group and per ``MAX_LEAVES`` leaves of it.
    """
    if not len(ps) == len(ms) == len(gs):
        raise ValueError(f"fused_sgd_update: {len(ps)} p, {len(ms)} m, "
                         f"{len(gs)} g leaves")
    groups = {}
    for p, m, g in zip(ps, ms, gs):
        check_inputs(p, m, g)
        if p.device.type != "cuda" and not is_fake(p):
            raise ValueError(f"fused_sgd_update: the kernel takes CUDA "
                             f"tensors, got {p.device}")
    if ps and is_fake(ps[0]):   # a traced call: nothing launched
        trace.fused_sgd_update_op(list(ps), list(ms), list(gs), float(eta),
                                  float(beta), float(wd))
        return
    for p, m, g in zip(ps, ms, gs):
        groups.setdefault((p.dtype, m.dtype, g.dtype, p.device), []).append(
            (p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel()))
    for (pt, mt, gt, dev), rows in groups.items():
        for i in range(0, len(rows), MAX_LEAVES):
            _launch(rows[i:i + MAX_LEAVES], pt, mt, gt, dev, eta, beta, wd)


def _launch(rows, p_dtype, m_dtype, g_dtype, device, eta, beta, wd):
    table = (ctypes.c_int64 * (4 * len(rows)))(*(v for r in rows for v in r))
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.repro_fused_sgd_update(
            table, len(rows), _DTYPE_CODE[p_dtype], _DTYPE_CODE[m_dtype],
            _DTYPE_CODE[g_dtype], float(eta), float(beta), float(wd), stream)
    fused_sgd_update.launches += 1
    check(status, "fused_sgd_update")


def fused_sgd_update(p, m, g, *, eta: float, beta: float = 0.0,
                     wd: float = 0.0):
    """The update of one leaf, in place: one launch of the same kernel.
    Returns (p, m), the same tensors, updated."""
    fused_sgd_update_leaves([p], [m], [g], eta=eta, beta=beta, wd=wd)
    return p, m


fused_sgd_update.launches = 0   # every launch of the kernel, any table
