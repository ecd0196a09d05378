"""RG-LRU recurrent block (RecurrentGemma / Griffin). [arXiv:2402.19427]

The port of ``src/repro/models/rglru.py:21-92``. The token recurrence
h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t) is a diagonal linear
recurrence. The JAX model evaluates it with ``lax.associative_scan``,
outside any Pallas kernel; here a multi-token call runs a log-depth
Hillis–Steele scan in plain PyTorch (``ceil(log2 S)`` out-of-place passes,
differentiable through autograd). A single-token call with a cache takes
the closed update ``a·state + b``.

The cache holds the conv carry (the last ``d_conv − 1`` conv inputs, in
the cache's type) and the float32 state (B, lru): O(1) in the sequence
length. It is written in place, as the Mamba2 caches are. A multi-token
call with a cache continues from both (the scan from ``cache["state"]``);
the transformer's ``prefill`` zeroes a reused row first and says so
(``fresh``), and the scan then starts from no state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _normal, dense_init
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding import shard

_C = 8.0  # Griffin's recurrence-gate temperature


def check_supported(cfg: ArchConfig):
    if cfg.rglru is None:
        raise ValueError(f"{cfg.name}: layer kind 'R' needs an RGLRUConfig")


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype):
    lru, d = _width(cfg), cfg.d_model
    return {
        "w_x": dense_init(gen, d, lru, dtype),
        "w_gate_lru": dense_init(gen, d, lru, dtype),
        "conv_lru": _normal(gen, (cfg.rglru.d_conv, lru), 0.1, dtype),
        "w_a": dense_init(gen, lru, lru, dtype),
        "w_i": dense_init(gen, lru, lru, dtype),
        # a = exp(-C·softplus(a_param)·r): a_param 4 puts a near 0.9..1
        "a_param": torch.full((lru,), 4.0, dtype=torch.float32,
                              device=gen.device),
        "w_out_lru": dense_init(gen, lru, d, dtype),
    }


def _gates(a_param, r, i, xb):
    """(a, b) of the recurrence h_t = a_t·h_{t-1} + b_t, float32."""
    log_a = -_C * F.softplus(a_param) * r        # log a_t (negative)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xb)
    return a, b


def _linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 along dim 1: Hillis–Steele
    doubling, each pass combining element t with element t − d."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rg_lru_scan(xb, r, i, a_param, initial_state=None):
    """xb, r, i: (B,S,lru) float32. Returns h (B,S,lru), final (B,lru)."""
    a, b = _gates(a_param, r, i, xb)
    if initial_state is not None:
        b = torch.cat([b[:, :1] + (a[:, 0] * initial_state)[:, None],
                       b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h, h[:, -1]


def apply_rglru(params, cfg: ArchConfig, x, cache=None, fresh=False):
    """x: (B,S,d). cache: None or {"conv": (B,K-1,lru), "state": (B,lru)},
    updated in place; ``fresh``: the caller has just zeroed the cache (a
    prefill), so the conv pads with zeros and the scan starts from no
    state. Returns (out (B,S,d), cache)."""
    S = x.shape[1]
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(x @ params["w_gate_lru"], approximate="tanh")
    xb = shard(x @ params["w_x"], None, None, "model")
    conv_carry = None if cache is None or fresh else cache["conv"]
    xb, new_conv = _causal_conv(xb, params["conv_lru"], conv_carry)

    r = torch.sigmoid((xb @ params["w_a"]).float())
    i = torch.sigmoid((xb @ params["w_i"]).float())
    xb32 = xb.float()

    if cache is None or S > 1:
        init = None if cache is None or fresh else cache["state"].float()
        h, final = _rg_lru_scan(xb32, r, i, params["a_param"], init)
    else:
        a, b = _gates(params["a_param"], r[:, 0], i[:, 0], xb32[:, 0])
        final = a * cache["state"].float() + b
        h = final[:, None, :]

    out = (h.to(x.dtype) * gate) @ params["w_out_lru"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(final)
    return out, cache


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype, device=None):
    lru = _width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.d_conv - 1, lru), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, lru), dtype=torch.float32,
                             device=device),
    }
