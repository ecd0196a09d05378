"""Analytical FLOPs / bytes model per (arch × shape).

The port's copy of ``src/repro/launch/flops.py``: the serving engine's
``DeviceModel`` prices prefills and decode steps with it, and
``chip_smoke.py`` takes the flash-attention kernel's bound from
``_attn_pairs``. Same arithmetic in the same order as the JAX package, so
both engines' modeled times agree to the last bit.

Conventions: 1 MAC = 2 FLOPs; training = fwd + 2×bwd (+⅓ remat recompute →
×4 fwd-equivalents with full activation checkpointing); attention FLOPs use
the true masked pair count (causal ½, window bands); MoE counts only routed
(active) experts + shared experts — MODEL_FLOPS = 6·N_active·D convention.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import padded_vocab


@dataclass
class FlopsReport:
    n_params: float            # total parameters
    n_active: float            # active per token (MoE: routed top-k + shared)
    fwd_flops: float           # one forward pass, all tokens, global
    step_flops: float          # the lowered program (train: fwd+bwd+remat)
    model_flops: float         # 6·N_active·D (train) or 2·N_active·D (decode)
    hbm_bytes: float           # param + activation traffic estimate, global
    breakdown: dict


def _attn_pairs(S: int, window, kind: str) -> float:
    """Masked (q,k) pair count per sequence for one layer."""
    if kind == "decode":
        return float(min(S, window) if window else S)
    if window and window < S:
        return float(window) * S - window * (window - 1) / 2.0
    return S * (S + 1) / 2.0


def count_params(cfg: ArchConfig) -> tuple[float, float]:
    """(total, active-per-token) parameter counts."""
    d = cfg.d_model
    vp = padded_vocab(cfg)
    att = cfg.attention
    total = vp * d  # embed
    if not cfg.tie_embeddings:
        total += d * vp
    per_layer_attn = 0.0
    if att:
        if att.kind == "gqa":
            per_layer_attn = d * att.n_heads * att.head_dim * 2 \
                + d * att.n_kv_heads * att.head_dim * 2
        else:
            qk = att.qk_nope_head_dim + att.qk_rope_head_dim
            q_in = (d * att.q_lora_rank + att.q_lora_rank * att.n_heads * qk) \
                if att.q_lora_rank else d * att.n_heads * qk
            per_layer_attn = (q_in + d * (att.kv_lora_rank + att.qk_rope_head_dim)
                              + att.kv_lora_rank * att.n_heads
                              * (att.qk_nope_head_dim + att.v_head_dim)
                              + att.n_heads * att.v_head_dim * d)
    dense_mlp = 3 * d * cfg.d_ff
    moe = cfg.moe
    total_active = 0.0
    kinds = cfg.layer_kinds()
    n_head_dense = moe.n_dense_layers if moe else 0
    for li, kind in enumerate(kinds):
        if kind in ("G", "L"):
            total += per_layer_attn
            total_active += per_layer_attn
            if moe and li >= n_head_dense:
                router = d * moe.n_experts
                expert = 3 * d * moe.d_expert
                shared = 3 * d * moe.n_shared * moe.d_expert
                total += router + moe.n_experts * expert + shared
                total_active += router + moe.top_k * expert + shared
            else:
                total += dense_mlp
                total_active += dense_mlp
        elif kind == "M":
            ssm = cfg.ssm
            d_inner = ssm.expand * d
            nh = d_inner // ssm.head_dim
            gN = ssm.n_groups * ssm.d_state
            w = d * (2 * d_inner + 2 * gN + nh) + d_inner * d
            total += w
            total_active += w
        elif kind == "R":
            lru = cfg.rglru.lru_width or d
            w = d * lru * 2 + lru * lru * 2 + lru * d + dense_mlp
            total += w
            total_active += w
    total_active += vp * d / max(1, 1)  # unembed matmul params touched
    return total, total_active


def shape_flops(cfg: ArchConfig, shape: ShapeConfig) -> FlopsReport:
    d = cfg.d_model
    att = cfg.attention
    S = shape.seq_len
    B = shape.global_batch
    mode = shape.mode
    tokens = B * (1 if mode == "decode" else S)

    n_params, n_active = count_params(cfg)

    # matmul flops: 2 × active params per token (excl. embed lookup)
    mm = 2.0 * (n_active - padded_vocab(cfg) * d) * tokens
    # unembed
    mm += 2.0 * padded_vocab(cfg) * d * tokens

    # attention score+value flops per layer
    attn = 0.0
    kinds = cfg.layer_kinds()
    for kind in kinds:
        if kind in ("G", "L") and att:
            window = att.window if kind == "L" else None
            pairs = _attn_pairs(S, window, "decode" if mode == "decode" else "full")
            hd_qk = (att.qk_nope_head_dim + att.qk_rope_head_dim
                     if att.kind == "mla" else att.head_dim)
            hd_v = att.v_head_dim if att.kind == "mla" else att.head_dim
            attn += 2.0 * att.n_heads * pairs * (hd_qk + hd_v) * B
        elif kind == "M":
            ssm = cfg.ssm
            d_inner = ssm.expand * d
            # SSD: intra-chunk 'attention' + state path ≈ 2·S·d_inner·d_state·2
            attn += 4.0 * tokens * d_inner * ssm.d_state
        elif kind == "R":
            lru = cfg.rglru.lru_width or d
            attn += 10.0 * tokens * lru  # elementwise recurrence, negligible

    fwd = mm + attn
    if mode == "train":
        step = 4.0 * fwd  # fwd + 2×bwd + ~1×remat recompute
        model_flops = 6.0 * n_active * tokens
    else:
        step = fwd
        model_flops = 2.0 * n_active * tokens

    # HBM traffic: params once (bf16) + activations (rough: 12 streams of
    # (tokens × d) bf16 per layer) + KV cache traffic for decode
    act = 12.0 * tokens * d * 2.0 * len(kinds)
    param_bytes = n_params * 2.0 * (3 if mode == "train" else 1)
    kv = 0.0
    if mode == "decode" and att:
        for kind in kinds:
            if kind not in ("G", "L"):
                continue
            window = att.window if kind == "L" else None
            eff = min(S, window) if window else S
            if att.kind == "mla":
                kv += B * eff * (att.kv_lora_rank + att.qk_rope_head_dim) * 2.0
            else:
                kv += B * eff * att.n_kv_heads * att.head_dim * 2.0 * 2.0
    hbm = param_bytes + act + kv

    return FlopsReport(
        n_params=n_params, n_active=n_active, fwd_flops=fwd, step_flops=step,
        model_flops=model_flops, hbm_bytes=hbm,
        breakdown={"matmul": mm, "attn": attn, "kv_bytes": kv,
                   "param_bytes": param_bytes, "act_bytes": act})
