"""Flash-attention entry point: the tensor's device picks the route.

A CUDA tensor goes through the Hopper kernel (or the call raises); a CPU
tensor goes through the plain version in ``ref.py``. There is no other
route and no fallback.

Both routes run inside one ``torch.autograd.Function``, the reference's
recompute custom VJP (``src/repro/kernels/flash_attention/ops.py:24-46``):
the forward is the route's, the backward recomputes the plain version
from the saved q, k, v and returns its vector-Jacobian product. So the
gradients do not depend on the route: on the card they equal those of the
plain version bit for bit. There is no Hopper backward kernel yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.trace import is_fake
from repro_torch.obs.trace import layer


def plain_attention(q, k, v, causal, window, softcap, scale):
    """The plain version in q's type: the CPU route's forward, and what
    the backward differentiates on both routes."""
    return R.attention_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale).to(q.dtype)


def _route(q, k, v, causal, window, softcap, scale):
    if q.device.type == "cuda" or is_fake(q):   # a trace: the kernel's op
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    K.check_inputs(q, k, v)
    return plain_attention(q, k, v, causal, window, softcap, scale)


class FlashAttention(torch.autograd.Function):
    """forward: the device's route; backward: the plain version
    recomputed and differentiated (the reference's ``_flash_bwd``). Each
    runs in its profiler range, ``flash_attention.forward`` (the remat
    recompute too) and ``flash_attention.backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        with layer("flash_attention.forward"):
            return _route(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        with layer("flash_attention.backward"), torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = plain_attention(*ins, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) → (B, Sq, H, D) in q's type.
    Differentiable in q, k and v on both routes."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale)

