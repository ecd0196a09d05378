"""Flash-attention entry point: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain version in ``ref.py``. There is no other
route and no fallback. Forward only: the serving path needs no gradient.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) → (B, Sq, H, D) in q's type."""
    if q.device.type == "cuda":
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    K.check_inputs(q, k, v)
    return R.attention_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale).to(q.dtype)
