"""Plain PyTorch version of the flash-attention kernel, float32 math.

The JAX package's ``attention_ref`` (``src/repro/kernels/flash_attention/
ref.py:18-50``) written in torch: grouped-query attention with optional
causal mask, sliding window and logit soft-capping, queries at the last Sq
positions of the Sk-long context. Used for CPU tensors and as what the CUDA
kernel is held to on the card; it materialises the (Sq, Sk) scores.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38

# What the bfloat16 kernel is held to against ``attention_ref`` rounded to
# bfloat16. Both outputs are rounded to bfloat16 (one step is up to 2^-7 of
# |ref|) and the kernel rounds the probabilities to bfloat16 for P.V (up to
# 2^-9 of each term, which an output near 0 does not scale down). So each
# element is held to |d| <= BF16_ATOL + BF16_RTOL * |ref|, and each (query
# row, head) to ||d|| <= BF16_ROW_TOL * ||ref||: a missed or repeated kv
# tile, or a window one key off, moves a late row by more than that.
BF16_ATOL, BF16_RTOL, BF16_ROW_TOL = 5e-3, 1e-2, 1e-2


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D). Returns (B, Sq, H, D) float32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / (D ** 0.5)

    qf = q.float().reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)

    pos_q = torch.arange(Sq, device=q.device) + (Sk - Sq)
    pos_k = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        ok &= pos_k[None, :] > pos_q[:, None] - window
    scores = scores.masked_fill(~ok, NEG_INF)

    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, D)


def bf16_mismatch(out, ref):
    """A bfloat16 output (B, Sq, H, D) against the plain version ``ref``.

    Returns (max |d|, worst |d| / (BF16_ATOL + BF16_RTOL * |ref|), worst
    per-row ||d|| / (BF16_ROW_TOL * ||ref||)); the output passes when both
    ratios are at most 1.
    """
    ref = ref.to(torch.bfloat16).float()
    d = (out.float() - ref).abs()
    elem = d / (BF16_ATOL + BF16_RTOL * ref.abs())
    row = d.norm(dim=-1) / (BF16_ROW_TOL * ref.norm(dim=-1)).clamp_min(1e-30)
    return float(d.max()), float(elem.max()), float(row.max())
