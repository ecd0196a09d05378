"""Launcher of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py:75``
(``flash_attention``). The kernel is bound by operations: 4·D FLOPs per
visible (query, key) pair against each input read once, so its bound on an
H100 SXM is the pair count over 989 TFLOP/s (bf16 dense). One launch covers
all batches, heads and query tiles; it takes any Sq ≤ Sk. bfloat16 runs on
the tensor cores (``wgmma``, fed by TMA loads through tensor maps the
launcher builds), float32 on the CUDA cores so that it keeps float32
accuracy.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import trace
from repro_torch.kernels.build import check, library
from repro_torch.kernels.trace import is_fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def check_inputs(q, k, v):
    """Raise on shapes the attention does not define (both routes)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    if not 1 <= Sq <= Sk:
        raise ValueError(f"flash_attention: needs 1 <= Sq <= Sk, got "
                         f"Sq={Sq}, Sk={Sk}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) → (B, Sq, H, D) in q's type.

    CUDA tensors only, contiguous and 16-byte aligned, one type (float32
    or bfloat16), D in ``HEAD_DIMS``. Anything else raises; nothing falls
    back.
    """
    check_inputs(q, k, v)
    if q.device.type != "cuda" and not is_fake(q):
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if is_fake(q):   # a traced call: the op's shapes, nothing launched
        return trace.flash_attention_op(q, k, v, bool(causal),
                                        int(window or 0),
                                        float(softcap or 0.0),
                                        float(scale if scale is not None
                                              else 1.0 / (D ** 0.5)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:   # a TMA map needs a 16-byte aligned base
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, D, _DTYPE_CODE[q.dtype], int(bool(causal)),
            int(window or 0), float(softcap or 0.0), float(scale), stream)
    flash_attention.launches += 1
    check(status, "flash_attention")
    return out


flash_attention.launches = 0
