"""The yardstick's arithmetic: peaks, and the operations and bytes of a
step and of each kernel's work, from shapes alone.

Frozen copies of the port's ``launch/flops.py`` (``count_params``, the
attention and SSD terms of ``shape_flops``) and ``kernels/trace.py``
(``masked_pairs``, ``ssd_flops``), over the configuration files' dicts,
so that a later change to the program cannot move them. Conventions: a
multiply-add is 2 FLOPs; a training step's model FLOPs are forward plus
twice it in the backward, the layers' remat recompute not counted.
"""
from __future__ import annotations

from bench.data import mamba_dims, padded_vocab

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def masked_pairs(S: int, window=None) -> float:
    """Visible causal (query, key) pairs of one head over S positions."""
    if window and window < S:
        return float(window) * S - window * (window - 1) / 2.0
    return S * (S + 1) / 2.0


def ssd_flops(b, S, H, P, G, N, chunk, init=False) -> float:
    """The SSD scan's forward FLOPs: per chunk of q rows C·Bᵀ over the
    lower triangle once a group, the intra-chunk product a head, the
    state term of y (from an entering state) and the state update."""
    Q = min(chunk, S)
    flops = 0.0
    for c in range(-(-S // Q)):
        q = min(Q, S - c * Q)
        tri = q * (q + 1) / 2
        flops += 2.0 * b * (G * tri * N + H * tri * P
                            + (H * q * N * P if c or init else 0)
                            + H * q * P * N)
    return flops


def ssd_bytes(b, S, H, P, G, N, init=False) -> float:
    """The SSD forward's float32 bytes: x, dt, A, B and C read once, y and
    the final state written once (the initial state read with ``init``)."""
    elems = (2 * b * S * H * P + b * S * H + H + 2 * b * S * G * N
             + b * H * P * N * (2 if init else 1))
    return 4.0 * elems


def matmul_params(model: dict) -> float:
    """Parameters every position multiplies (``count_params``'s active
    count: the layers' matrices and the output head)."""
    d = model["d_model"]
    per_layer = 0.0
    kind = model["block_pattern"][0]
    if kind == "M":
        d_inner, H, _, d_in_proj = mamba_dims(model)
        per_layer = d * d_in_proj + d_inner * d
    else:
        a = model["attention"]
        per_layer = (2 * d * a["n_heads"] * a["head_dim"]
                     + 2 * d * a["n_kv_heads"] * a["head_dim"]
                     + 3 * d * model["d_ff"])
    return model["n_layers"] * per_layer + padded_vocab(model) * d


def mixing_flops(model: dict, rows: int, S: int) -> float:
    """The forward FLOPs of the layers' sequence mixing over ``rows`` rows
    of S positions: causal attention's masked pairs (QKᵀ and PV), or
    ``shape_flops``'s SSD term 4·tokens·d_inner·d_state."""
    kind = model["block_pattern"][0]
    if kind == "M":
        d_inner = mamba_dims(model)[0]
        per_layer = 4.0 * rows * S * d_inner * model["ssm"]["d_state"]
    else:
        a = model["attention"]
        per_layer = (2.0 * a["n_heads"] * masked_pairs(S, a.get("window"))
                     * 2 * a["head_dim"] * rows)
    return model["n_layers"] * per_layer


def train_step_flops(model: dict, rows: int, tokens: int,
                     frames: int = 0) -> float:
    """Model FLOPs of one local step over ``rows`` rows (all clients) of
    ``frames`` + ``tokens`` positions: 6 a matmul parameter a position,
    the frontend projection's on its frames, and three times the forward
    sequence mixing. The remat recompute is not counted."""
    S = frames + tokens
    f = 6.0 * matmul_params(model) * rows * S
    if frames:
        f += 6.0 * model["frontend_dim"] * model["d_model"] * rows * frames
    return f + 3.0 * mixing_flops(model, rows, S)


def flash_fwd_bound_s(model: dict, rows: int, S: int) -> float:
    """The least time of one causal flash-attention forward over ``rows``
    rows of S positions in bfloat16: its tensor-core FLOPs (QKᵀ and PV over
    the masked pairs) at the bf16 peak, or q, k, v read and o written
    once at the HBM rate, whichever is longer."""
    a = model["attention"]
    H, KV, D = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    flops = 4.0 * rows * H * D * masked_pairs(S, a.get("window"))
    nbytes = 2.0 * rows * S * D * (2 * H + 2 * KV)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def ssd_fwd_bound_s(model: dict, rows: int, S: int) -> float:
    """The least time of one SSD forward over ``rows`` rows of S positions:
    its FLOPs at the bf16 tensor-core peak (no float32 scheme is faster)
    or its float32 bytes at the HBM rate, whichever is longer."""
    s = model["ssm"]
    d_inner, H, _, _ = mamba_dims(model)
    shape = (rows, S, H, s["head_dim"], s["n_groups"], s["d_state"])
    return max(ssd_flops(*shape, s["chunk_size"]) / PEAK_BF16_FLOPS,
               ssd_bytes(*shape) / PEAK_HBM_BYTES)


def update_bytes(leaves) -> float:
    """Bytes one plain-SGD update (momentum 0) of a replica must move:
    each parameter and its gradient (in the parameter's type) read once,
    the parameter and its float32 moment written once. ``leaves``: (number
    of elements, bytes an element) a leaf."""
    return sum(n * (3 * size + 4) for n, size in leaves)
