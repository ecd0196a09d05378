"""Shared neural-net building blocks (pure functions, dict params).

The port of ``src/repro/models/layers.py:16-83``. Weights keep the JAX
package's layout (``x @ w`` with w as (d_in, d_out)); the init helpers draw
from a ``torch.Generator`` in float32 on the generator's device and cast to
the target type, so a full-width model is never staged on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.sharding import shard


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)              # (hd/2,)
    ang = positions[..., None].float() * inv                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype):
    if gen.device.type == "meta":   # a shape template: nothing drawn
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype):
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return _normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def apply_mlp(params, x):
    h = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = shard(torch.nn.functional.silu(h) * u, *((None,) * (x.ndim - 1)),
              "model")
    return h @ params["w_down"]
