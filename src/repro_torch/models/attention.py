"""Attention variants with KV caches: GQA (qk_norm / softcap / sliding
window, optionally an int8 cache) and MLA.

The port of ``src/repro/models/attention.py``. Three execution modes from
one function, as in the JAX package:

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

The int8 KV cache (``cfg.kv_quant``) stores k and v symmetric-quantised
per position and head; prefill attends over the unquantised k/v and
stores quantised tails, decode dequantises the whole cache to the
activation type before attending, as the reference does.

MLA (DeepSeek-V2 / MiniCPM3) caches the compressed latent and the rope key.
Prefill and training expand them to per-head k/v and run the flash kernel,
with q, k and v zero-padded along the head dim to the next size the kernel
takes (``_padded_flash``); decode is the absorbed form in float32 (scores
in latent space), plain torch like the GQA decode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, AttentionConfig
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap
from repro_torch.sharding import shard
from repro_torch.sharding.rules import (MODEL_AXIS, contiguous_grad,
                                        head_placements, is_dtensor,
                                        local_shape_and_offset, model_size,
                                        unshard_dim)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype):
    att = cfg.attention
    d = cfg.d_model
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    if att.kind == "gqa":
        p = {
            "wq": dense_init(gen, d, att.n_heads * att.head_dim, dtype),
            "wk": dense_init(gen, d, att.n_kv_heads * att.head_dim, dtype),
            "wv": dense_init(gen, d, att.n_kv_heads * att.head_dim, dtype),
            "wo": dense_init(gen, att.n_heads * att.head_dim, d, dtype),
        }
        if att.qk_norm:
            p["q_norm"] = zeros(att.head_dim)
            p["k_norm"] = zeros(att.head_dim)
        return p
    if att.kind != "mla":
        raise ValueError(att.kind)
    qk_dim = att.qk_nope_head_dim + att.qk_rope_head_dim
    r, H = att.kv_lora_rank, att.n_heads
    p = {
        "w_dkv": dense_init(gen, d, r + att.qk_rope_head_dim, dtype),
        "kv_norm": zeros(r),
        "w_uk": dense_init(gen, r, H * att.qk_nope_head_dim, dtype),
        "w_uv": dense_init(gen, r, H * att.v_head_dim, dtype),
        "wo": dense_init(gen, H * att.v_head_dim, d, dtype),
    }
    if att.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, att.q_lora_rank, dtype)
        p["q_norm"] = zeros(att.q_lora_rank)
        p["w_uq"] = dense_init(gen, att.q_lora_rank, H * qk_dim, dtype)
    else:
        p["wq"] = dense_init(gen, d, H * qk_dim, dtype)
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
    if is_dtensor(q):
        return _attend_on_shards(q, k, v, bias, cap, scale)
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


def _attend_on_shards(q, k, v, bias, cap, scale):
    """``attend`` on each rank's block (``local_map``): the batch rows as
    the cache splits them over the data axes, the heads split on `model`
    where the KV heads divide, the cache's sequence whole (a cache split
    by sequence is gathered: the softmax runs over all of it)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    split = k.shape[2] % model_size(q) == 0
    names = q.device_mesh.mesh_dim_names

    def place(x, heads):
        out = []
        for n, p in zip(names, x.placements):
            if n == "model":
                out.append(Shard(heads) if split and heads else Replicate())
            else:
                out.append(Shard(0) if isinstance(p, Shard) and p.dim == 0
                           else Replicate())
        return tuple(out)

    batch = place(k, None)   # the cache's batch split, nothing on model
    kp = place(k, 2)
    qp = tuple(kp)
    bp = tuple(Shard(0) if isinstance(p, Shard) else Replicate()
               for p in batch) if bias.dim() == 3 else \
        (Replicate(),) * len(names)
    return local_map(
        lambda a, b, c, d: attend(a, b, c, d, cap, scale),
        out_placements=list(qp), in_placements=(qp, kp, kp, bp),
        device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v, bias)


def _flash(q, k, v, **kw):
    """``flash_attention``; on DTensors (a client's forward on a mesh) on
    each rank's heads (``_flash_on_shards``)."""
    if is_dtensor(q):
        return _flash_on_shards(q, k, v, **kw)
    return flash_attention(q, k, v, **kw)


def _flash_on_shards(q, k, v, **kw):
    """The kernel's Function on each rank's heads, through ``local_map``
    (its saved tensors local).

    Heads split on ``model`` where H does: Megatron's contiguous split, so
    rank r holds q heads [r·Hl, (r+1)·Hl). Where the KV heads split too,
    k and v split the same way. Where they do not (8 KV heads on 16
    ranks), k and v are replicated and each rank takes the KV heads its q
    heads read (group G = H / KV; needs Hl a multiple of G or G of Hl);
    their gradients are then partial sums over the ranks. Otherwise every
    rank computes every head."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    H, KV, m = q.shape[2], k.shape[2], model_size(q)
    Hl, G = H // m, H // KV
    cg = contiguous_grad
    fn = lambda a, b, c: flash_attention(cg(a), cg(b), cg(c), **kw)
    if H % m == 0 and KV % m == 0:
        qp = kp = grad_kp = head_placements(q, 2, True)
    elif H % m == 0 and (Hl % G == 0 or G % Hl == 0):
        qp = head_placements(q, 2, True)
        kp = head_placements(k, 2, False)
        grad_kp = head_placements(k, 2, False, Partial())
        lo = q.device_mesh.get_local_rank(MODEL_AXIS) * Hl // G
        hi = lo + max(1, Hl // G)

        def fn(a, b, c):
            return flash_attention(cg(a), cg(b[:, :, lo:hi].contiguous()),
                                   cg(c[:, :, lo:hi].contiguous()), **kw)
    else:
        qp = kp = grad_kp = head_placements(q, 2, False)
    return local_map(fn, out_placements=list(qp),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, grad_kp, grad_kp),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


# ---------------------------------------------------------------------------
# GQA apply
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    if is_dtensor(x) and n % model_size(x):
        # on a mesh, heads that do not split over `model`: the columns
        # are gathered before they are cut into heads
        x = unshard_dim(x, -1)
    return x.reshape(x.shape[:-1] + (n, hd))


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (symmetric, per position x head)
# ---------------------------------------------------------------------------

def _quant(x):
    """x: (..., hd) → (int8 codes, float32 scales (...,)); round half to
    even, as ``jnp.round``. Both divisions are tensor by tensor: CUDA
    divides by a Python scalar as a multiplication by its reciprocal, an
    ulp off the reference's quotient."""
    xf = x.float()
    peak = torch.amax(torch.abs(xf), dim=-1).clamp_min(1e-8)
    scale = peak / torch.full_like(peak, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def apply_gqa(params, att: AttentionConfig, x, pos_q, *, window, eps,
              cache=None, cache_pos=None, kv_quant=False):
    """x: (B, S, d). pos_q: (S,) or (B, S) absolute positions of x's tokens.

    cache: None (full sequence) or {"k","v"} buffers (B, C, KV, hd), C the
    max length (full cache) or the window (ring buffer), written in place.
    With S > 1 the cache must be empty (prefill from zero, as in the JAX
    package); with S == 1, cache_pos (B,) is each row's count of tokens
    already in the cache. With ``kv_quant`` the cache holds int8 ``k`` /
    ``v`` and float32 ``k_scale`` / ``v_scale`` (B, C, KV). Returns (out,
    cache).
    """
    B, S, d = x.shape
    q = _split_heads(x @ params["wq"], att.n_heads, att.head_dim)
    k = _split_heads(x @ params["wk"], att.n_kv_heads, att.head_dim)
    v = _split_heads(x @ params["wv"], att.n_kv_heads, att.head_dim)
    q = shard(q, None, None, "model", None)
    k = shard(k, None, None, "model", None)
    v = shard(v, None, None, "model", None)
    if att.qk_norm:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    q = apply_rope(q, pos_q, att.rope_theta)
    k = apply_rope(k, pos_q, att.rope_theta)
    scale = 1.0 / math.sqrt(att.head_dim)

    if cache is None or S > 1:
        # full sequence / prefill: the flash-attention kernel
        out = _flash(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=True, window=window, softcap=att.logit_softcap,
                     scale=scale)
        if cache is not None and kv_quant:
            for name, t in (("k", k), ("v", v)):
                codes, s = _quant(t)
                _write_tail(cache[name], codes)
                _write_tail(cache[f"{name}_scale"], s)
        elif cache is not None:
            _write_tail(cache["k"], k)
            _write_tail(cache["v"], v)
    else:
        C = cache["k"].shape[1]
        slot = torch.remainder(cache_pos, C)
        if kv_quant:
            for name, t in (("k", k), ("v", v)):
                codes, s = _quant(t[:, 0])
                write_rows(cache[name], slot, codes)
                write_rows(cache[f"{name}_scale"], slot, s)
            # the whole cache, dequantised to the activation type
            kr = _dequant(cache["k"], cache["k_scale"], x.dtype)
            vr = _dequant(cache["v"], cache["v_scale"], x.dtype)
        else:
            write_rows(cache["k"], slot, k[:, 0])
            write_rows(cache["v"], slot, v[:, 0])
            kr, vr = cache["k"], cache["v"]
        pos_k = _cache_positions(C, cache_pos)                  # (B, C)
        bias = _mask_bias(pos_q.expand(B, 1), pos_k, window)    # (B, 1, C)
        out = attend(q, kr, vr, bias, att.logit_softcap, scale)

    out = out.reshape(B, S, -1) @ params["wo"]
    return out, cache


def write_rows(buf, slot, val):
    """buf[b, slot[b]] = val[b] for every batch row b, in place, in buf's
    type. On a mesh (DTensors) each rank writes its own rows and, with the
    cache's sequence split over the data axes, only the slots it holds:
    the rest of each row's write lands on the slot it already holds, with
    the value it has, so no shape depends on the data."""
    if not is_dtensor(buf):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot] = val.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = buf.device_mesh, tuple(buf.placements)
    _, off = local_shape_and_offset(buf.shape, mesh, pl)
    # slot and val: split by batch as buf is; val's other dims follow
    # buf's minus the slot dim
    rows_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                    else Replicate() for p in pl)
    val_pl = tuple(p if not isinstance(p, Shard) or p.dim == 0
                   else Replicate() if p.dim == 1 else Shard(p.dim - 1)
                   for p in pl)

    def local(b, s, v):
        n = b.shape[1]
        at = s - off[1]
        inside = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        rows = torch.arange(b.shape[0], device=b.device)
        keep = b[rows, at]
        mask = inside.reshape((-1,) + (1,) * (keep.dim() - 1))
        b[rows, at] = torch.where(mask, v.to(b.dtype), keep)

    local_map(local, out_placements=None, in_placements=(pl, rows_pl, val_pl),
              device_mesh=mesh, redistribute_inputs=True)(buf, slot, val)


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
    elif is_dtensor(buf):
        _write_head_on_shards(buf, x)
    else:
        buf[:, :S].copy_(x)
    return buf


def _write_head_on_shards(buf, x):
    """``buf[:, :S] = x`` for a cache on a mesh: each rank writes the
    positions its block holds (a slice of a DTensor along a split dim is a
    copy, not a view, so writing through one would be lost)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(buf.placements)
    _, off = local_shape_and_offset(buf.shape, buf.device_mesh, pl)
    S = x.shape[1]
    xpl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in pl)

    def local(b, v):
        lo, n = off[1], b.shape[1]
        a, z = max(lo, 0), min(lo + n, S)
        if a < z:
            b[:, a - lo:z - lo].copy_(v[:, a:z])

    local_map(local, out_placements=None, in_placements=(pl, xpl),
              device_mesh=buf.device_mesh, redistribute_inputs=True)(buf, x)


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
    C = min(max_len, window) if window is not None else max_len
    shape = (batch, C, att.n_kv_heads, att.head_dim)
    if kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA apply
# ---------------------------------------------------------------------------

def _padded_head_dim(att: AttentionConfig) -> int:
    """The flash kernel's head dim for MLA: the smallest it takes that
    holds q/k's (nope + rope) and v's."""
    need = max(att.qk_nope_head_dim + att.qk_rope_head_dim, att.v_head_dim)
    for D in HEAD_DIMS:
        if D >= need:
            return D
    raise ValueError(f"MLA head dims {need} exceed the flash kernel's "
                     f"{HEAD_DIMS}")


def _padded_flash(q, k, v, D: int, *, window, softcap, scale):
    """Causal attention of q, k (B, S, H, Dqk) and v (B, S, H, Dv) through
    the flash kernel, which takes one head dim D for all three: each is
    zero-padded to D (the zeros add nothing to the scores), the scale is
    passed explicitly, and the output is cut back to Dv."""
    dv = v.shape[-1]
    pad = lambda t: F.pad(t, (0, D - t.shape[-1]))   # a new, dense tensor
    out = _flash(pad(q), pad(k), pad(v), causal=True, window=window,
                 softcap=softcap, scale=scale)
    return out[..., :dv]


def _mla_q(params, att: AttentionConfig, x, pos_q, eps):
    B, S, _ = x.shape
    qk_dim = att.qk_nope_head_dim + att.qk_rope_head_dim
    if att.q_lora_rank:
        cq = rms_norm(x @ params["w_dq"], params["q_norm"], eps)
        q = cq @ params["w_uq"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, att.n_heads, qk_dim)
    q = shard(q, None, None, "model", None)
    q_nope = q[..., :att.qk_nope_head_dim]
    q_rope = apply_rope(q[..., att.qk_nope_head_dim:], pos_q, att.rope_theta)
    return q_nope, q_rope


def apply_mla(params, att: AttentionConfig, x, pos_q, *, window, eps,
              cache=None, cache_pos=None):
    """MLA attention. cache: None or {"ckv": (B, C, r), "k_rope": (B, C,
    rd)}, written in place; the arguments as ``apply_gqa``'s."""
    B, S, d = x.shape
    H = att.n_heads
    nope, rd = att.qk_nope_head_dim, att.qk_rope_head_dim
    vd, r = att.v_head_dim, att.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rd)

    q_nope, q_rope = _mla_q(params, att, x, pos_q, eps)
    dkv = x @ params["w_dkv"]
    ckv = rms_norm(dkv[..., :r], params["kv_norm"], eps)            # (B,S,r)
    k_rope = apply_rope(dkv[..., r:][:, :, None, :], pos_q,
                        att.rope_theta)[:, :, 0, :]                 # (B,S,rd)

    if cache is None or S > 1:
        k_nope = (ckv @ params["w_uk"]).reshape(B, S, H, nope)
        v = (ckv @ params["w_uv"]).reshape(B, S, H, vd)
        k_nope = shard(k_nope, None, None, "model", None)
        v = shard(v, None, None, "model", None)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # the single rope key head joins every head's k in the copy cat
        # makes (an expanded view would not be contiguous)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)],
                      dim=-1)
        out = _padded_flash(q, k, v, _padded_head_dim(att), window=window,
                            softcap=att.logit_softcap, scale=scale)
        if cache is not None:   # prefill: store the latent tail
            _write_tail(cache["ckv"], ckv)
            _write_tail(cache["k_rope"], k_rope)
    else:
        # absorbed decode in float32: scores and values in latent space
        C = cache["ckv"].shape[1]
        slot = torch.remainder(cache_pos, C)
        write_rows(cache["ckv"], slot, ckv[:, 0])
        write_rows(cache["k_rope"], slot, k_rope[:, 0])
        ckv_c, kr_c = cache["ckv"].float(), cache["k_rope"].float()
        w_uk = params["w_uk"].reshape(r, H, nope).float()
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
        scores = torch.einsum("bshr,bcr->bhsc", q_lat, ckv_c)
        scores = scores + torch.einsum("bshr,bcr->bhsc", q_rope.float(),
                                       kr_c)
        scores = softcap(scores * scale, att.logit_softcap)
        pos_k = _cache_positions(C, cache_pos)                  # (B, C)
        bias = _mask_bias(pos_q.expand(B, 1), pos_k, window)    # (B, 1, C)
        w = torch.softmax(scores + bias[:, None], dim=-1)
        o_lat = torch.einsum("bhsc,bcr->bshr", w, ckv_c)
        w_uv = params["w_uv"].reshape(r, H, vd).float()
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).to(x.dtype)

    out = out.reshape(B, S, -1) @ params["wo"]
    return out, cache


def init_mla_cache(att: AttentionConfig, batch: int, max_len: int, window,
                   dtype, device=None):
    C = min(max_len, window) if window is not None else max_len
    return {"ckv": torch.zeros((batch, C, att.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, C, att.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Unified entry
# ---------------------------------------------------------------------------

def apply_attention(params, cfg: ArchConfig, x, pos_q, *, is_local: bool,
                    cache=None, cache_pos=None):
    att = cfg.attention
    window = att.window if is_local else None
    if att.kind == "mla":
        # the latent cache is already small; kv_quant does not apply to
        # it, as in the reference
        return apply_mla(params, att, x, pos_q, window=window,
                         eps=cfg.norm_eps, cache=cache, cache_pos=cache_pos)
    return apply_gqa(params, att, x, pos_q, window=window, eps=cfg.norm_eps,
                     cache=cache, cache_pos=cache_pos, kv_quant=cfg.kv_quant)


def init_attention_cache(cfg: ArchConfig, is_local: bool, batch: int,
                         max_len: int, dtype, device=None):
    att = cfg.attention
    window = att.window if is_local else None
    if att.kind == "mla":
        return init_mla_cache(att, batch, max_len, window, dtype,
                              device=device)
    return init_gqa_cache(att, batch, max_len, window, dtype,
                          kv_quant=cfg.kv_quant, device=device)
