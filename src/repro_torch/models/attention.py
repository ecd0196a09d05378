"""Grouped-query attention (qk_norm / softcap / sliding window) with KV caches.

The port of ``src/repro/models/attention.py:72-261, 346-365``, GQA only.
Three execution modes from one function, as in the JAX package:

  * full sequence (scoring / prefill): the Hopper flash-attention kernel
    (``kernels/flash_attention``) computes causal, sliding-window and
    soft-capped attention in one launch per layer; a CPU tensor takes its
    plain version. At prefill from an empty cache the queries sit at
    positions ``0..S-1``, exactly the kernel's ``seq_off = 0`` semantics;
  * single-token decode against a full KV cache, and
  * single-token decode against a ring-buffer (sliding-window) cache:
    plain torch ops (``attend``), as the JAX package computes decode with
    einsum outside any Pallas kernel. Ring slots hold positions out of
    order and unwritten slots are masked, which the kernel's contiguous
    positions do not describe.

Unlike JAX's functional updates, the cache is written in place and the same
dict is returned: a full-width cache slot is gigabytes, and the serving
engine prefills straight into a view of its slot. Decode takes one position
per batch row (``cache_pos`` of shape (B,)), so one call decodes a batch of
independent sequences, each writing its own ring slot with its own mask.
MLA and int8 KV caches wait for later slices (ROADMAP queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, AttentionConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap

NEG_INF = -2.0e38


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1: {what})")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype):
    att = cfg.attention
    if att is None or att.kind != "gqa":
        raise _not_ported("MLA")
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, d, att.n_heads * att.head_dim, dtype),
        "wk": dense_init(gen, d, att.n_kv_heads * att.head_dim, dtype),
        "wv": dense_init(gen, d, att.n_kv_heads * att.head_dim, dtype),
        "wo": dense_init(gen, att.n_heads * att.head_dim, d, dtype),
    }
    if att.qk_norm:
        p["q_norm"] = torch.zeros((att.head_dim,), dtype=dtype,
                                  device=gen.device)
        p["k_norm"] = torch.zeros((att.head_dim,), dtype=dtype,
                                  device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Mask / plain attention (decode)
# ---------------------------------------------------------------------------

def _mask_bias(pos_q, pos_k, window: Optional[int]):
    """(..., Sq, Sk) additive bias: causal (+ sliding window).

    pos_q (..., Sq), pos_k (..., Sk) integer positions; leading dims
    broadcast (one row of positions per batch row in decode).
    """
    pq, pk = pos_q[..., :, None], pos_k[..., None, :]
    ok = pk <= pq
    if window is not None:
        ok &= pk > pq - window
    ok &= pk >= 0  # ring-buffer slots not yet written carry pos -1
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attend(q, k, v, bias, cap: Optional[float], scale: float):
    """q: (B,Sq,H,hd) k,v: (B,Sk,KV,hd), grouped-query without repeating KV.

    bias: (Sq, Sk) or (B, Sq, Sk). The plain-op path (the JAX package's
    ``_attend_block``); decode calls it with Sq = 1, so the (Sq, Sk) scores
    stay small and the JAX package's q-chunking is not needed.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale
    scores = softcap(scores, cap)
    if bias.dim() == 3:
        bias = bias[:, None, None]
    scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA apply
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def apply_gqa(params, att: AttentionConfig, x, pos_q, *, window, eps,
              cache=None, cache_pos=None, kv_quant=False):
    """x: (B, S, d). pos_q: (S,) or (B, S) absolute positions of x's tokens.

    cache: None (full sequence) or {"k","v"} buffers (B, C, KV, hd), C the
    max length (full cache) or the window (ring buffer), written in place.
    With S > 1 the cache must be empty (prefill from zero, as in the JAX
    package); with S == 1, cache_pos (B,) is each row's count of tokens
    already in the cache. Returns (out, cache).
    """
    if kv_quant:
        raise _not_ported("kv_quant")
    B, S, d = x.shape
    q = _split_heads(x @ params["wq"], att.n_heads, att.head_dim)
    k = _split_heads(x @ params["wk"], att.n_kv_heads, att.head_dim)
    v = _split_heads(x @ params["wv"], att.n_kv_heads, att.head_dim)
    if att.qk_norm:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    q = apply_rope(q, pos_q, att.rope_theta)
    k = apply_rope(k, pos_q, att.rope_theta)
    scale = 1.0 / math.sqrt(att.head_dim)

    if cache is None or S > 1:
        # full sequence / prefill: the flash-attention kernel
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=window,
                              softcap=att.logit_softcap, scale=scale)
        if cache is not None:
            _write_tail(cache["k"], k)
            _write_tail(cache["v"], v)
    else:
        C = cache["k"].shape[1]
        rows = torch.arange(B, device=x.device)
        slot = torch.remainder(cache_pos, C)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        pos_k = _cache_positions(C, cache_pos)                  # (B, C)
        bias = _mask_bias(pos_q.expand(B, 1), pos_k, window)    # (B, 1, C)
        out = attend(q, cache["k"], cache["v"], bias, att.logit_softcap,
                     scale)

    out = out.reshape(B, S, -1) @ params["wo"]
    return out, cache


def _write_tail(buf, x):
    """Store the last C positions of x (B,S,...) into the cache buffer
    (B,C,...), in place. Prefill-from-zero only. Ring invariant: slot j
    holds position p with p % C == j, so for S > C the tail is rolled by
    S % C."""
    C, S = buf.shape[1], x.shape[1]
    if S >= C:
        tail = x[:, -C:]
        if S % C:
            tail = torch.roll(tail, S % C, dims=1)
        buf.copy_(tail)
    else:
        buf[:, :S].copy_(x)
    return buf


def _cache_positions(C: int, cache_pos):
    """Absolute position held by each of the C cache slots after writing the
    token at ``cache_pos`` into slot ``cache_pos % C`` (ring semantics).

    cache_pos: (B,) → (B, C). Slots never written hold -1 (masked out by
    _mask_bias).
    """
    slots = torch.arange(C, device=cache_pos.device)
    cur = torch.remainder(cache_pos, C)[:, None]
    base = cache_pos[:, None] - cur  # start of the current ring revolution
    pos = torch.where(slots <= cur, base + slots, base - C + slots)
    return torch.where(pos >= 0, pos, torch.full_like(pos, -1))


def init_gqa_cache(att: AttentionConfig, batch: int, max_len: int, window,
                   dtype, kv_quant=False, device=None):
    if kv_quant:
        raise _not_ported("kv_quant")
    C = min(max_len, window) if window is not None else max_len
    shape = (batch, C, att.n_kv_heads, att.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Unified entry
# ---------------------------------------------------------------------------

def apply_attention(params, cfg: ArchConfig, x, pos_q, *, is_local: bool,
                    cache=None, cache_pos=None):
    att = cfg.attention
    if att.kind != "gqa":
        raise _not_ported("MLA")
    window = att.window if is_local else None
    return apply_gqa(params, att, x, pos_q, window=window, eps=cfg.norm_eps,
                     cache=cache, cache_pos=cache_pos, kv_quant=cfg.kv_quant)


def init_attention_cache(cfg: ArchConfig, is_local: bool, batch: int,
                         max_len: int, dtype, device=None):
    att = cfg.attention
    if att.kind != "gqa":
        raise _not_ported("MLA")
    window = att.window if is_local else None
    return init_gqa_cache(att, batch, max_len, window, dtype,
                          kv_quant=cfg.kv_quant, device=device)
