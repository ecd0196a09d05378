"""Mixture-of-Experts layer: top-k router, capacity dispatch, shared experts.

The port of ``src/repro/models/moe.py:21-119``, its grouped path: each
batch row is its own capacity pool (the reference vmaps ``_moe_pool`` over
B), so a decode step's slots never share expert capacity and a batched
token equals the one ``greedy_decode`` gives. The rows' pools are batched
into one ``(E, B·C, d)`` product per projection (``torch.bmm``: the
reference computes them with einsum outside any Pallas kernel), so the
expert weights are read once per call, not once per row.

Dispatch keeps the reference's semantics: the router in float32, softmax
then top-k, the gates renormalised; each (token, choice) assignment ranked
within its expert by a running count over the flattened ``T·k``
assignments in token-major order; assignments past the capacity ``C`` sent
to a sink row ``E·C`` that is discarded (the only duplicate writes of the
dispatch go there, and a dropped assignment's gradient is zero). The
combine adds a token's k weighted picks in k order, starting from zeros —
the order of the reference's ``.at[token_of].add`` — with no atomics, so it
is deterministic on the card. The route, dispatch, expert products and
combine each run in a profiler range (``moe.*``, ``obs/trace.layer``)
that a profile reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import _normal, apply_mlp, dense_init, init_mlp
from repro_torch.obs.trace import layer
from repro_torch.sharding import shard


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype):
    """The router is a float32 leaf even in a bf16 model, as in the
    reference."""
    moe = cfg.moe
    d, de, E = cfg.d_model, moe.d_expert, moe.n_experts
    p = {
        "w_router": dense_init(gen, d, E, torch.float32),
        "we_gate": _expert_init(gen, E, d, de, dtype),
        "we_up": _expert_init(gen, E, d, de, dtype),
        "we_down": _expert_init(gen, E, de, d, dtype),
    }
    if moe.n_shared > 0:
        # shared experts = one dense SwiGLU of width n_shared * d_expert
        p["shared"] = init_mlp(gen, d, moe.n_shared * de, dtype)
    return p


def _expert_init(gen, E, d_in, d_out, dtype):
    return _normal(gen, (E, d_in, d_out), 1.0 / (d_in ** 0.5), dtype)


def capacity(moe: MoEConfig, T: int) -> int:
    """Slots per expert for a pool of T tokens: the reference's formula,
    evaluated in that order in Python floats and truncated by ``int``."""
    return max(1, min(T, int(T * moe.top_k / moe.n_experts
                             * moe.capacity_factor)))


class Routing(NamedTuple):
    """The assignment of G pools of T tokens, k choices each."""

    gate: torch.Tensor    # (G, T, k) renormalised top-k gates, float32
    idx: torch.Tensor     # (G, T, k) expert of each choice
    rank: torch.Tensor    # (G, T·k) position within its expert
    keep: torch.Tensor    # (G, T·k) rank < C
    slot: torch.Tensor    # (G, T·k) in [0, E·C]; E·C is the sink
    capacity: int
    aux: torch.Tensor     # (G,) Switch load-balance loss of each pool


def route(params, moe: MoEConfig, x) -> Routing:
    """x: (G, T, d), G independent pools → their ``Routing``."""
    G, T, _ = x.shape
    E, k = moe.n_experts, moe.top_k
    logits = x.float() @ params["w_router"]                 # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=1)                                  # (G, E)
    ce = F.one_hot(idx, E).float().sum(dim=2).mean(dim=1)   # (G, E)
    aux = moe.aux_coef * E * (me * ce).sum(dim=-1)

    C = capacity(moe, T)
    flat_e = idx.reshape(G, T * k)
    onehot = F.one_hot(flat_e, E)                           # (G, T·k, E)
    rank = (onehot.cumsum(dim=1) - 1).gather(2, flat_e[..., None])[..., 0]
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank.clamp_max(C - 1),
                       torch.full_like(flat_e, E * C))
    return Routing(gate, idx, rank, keep, slot, C, aux)


def _experts(params, buf):
    """The batched SwiGLU over (E, N, d) buffers."""
    h = torch.bmm(buf, params["we_gate"])
    u = torch.bmm(buf, params["we_up"])
    return torch.bmm(F.silu(h) * u, params["we_down"])


def _moe_rows(params, moe: MoEConfig, x):
    """Dispatch + compute + combine for G pools. x: (G, T, d) →
    (y (G, T, d), aux (G,))."""
    G, T, d = x.shape
    E, k = moe.n_experts, moe.top_k
    with layer("moe.route"):
        r = route(params, moe, x)
    C = r.capacity
    EC = E * C

    # dispatch: each assignment's token row into its slot of its pool's
    # (E·C + 1, d) buffer; every dropped assignment writes the sink row
    with layer("moe.dispatch"):
        rows = x[:, :, None].expand(G, T, k, d).reshape(G * T * k, d)
        base = torch.arange(G, device=x.device)[:, None] * (EC + 1)
        buf = torch.index_put(x.new_zeros(G * (EC + 1), d),
                              ((r.slot + base).reshape(-1),), rows)
        buf = buf.view(G, EC + 1, d)[:, :EC].reshape(G, E, C, d)
        buf = buf.transpose(0, 1).reshape(E, G * C, d)

    with layer("moe.experts"):
        out = _experts(params, buf)                         # (E, G·C, d)

    # combine: each assignment's slot output, weighted by its gate in the
    # activation type, a token's k picks added in k order from zeros
    with layer("moe.combine"):
        out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, EC, d)
        src = r.slot.clamp_max(EC - 1)
        picked = torch.gather(out, 1, src[..., None].expand(G, T * k, d))
        picked = torch.where(r.keep[..., None], picked,
                             torch.zeros_like(picked))
        picked = picked * r.gate.reshape(G, T * k, 1).to(x.dtype)
        picked = picked.reshape(G, T, k, d)
        y = torch.zeros_like(x)
        for j in range(k):
            y = y + picked[:, :, j]
    return y, r.aux


def _moe_pool(params, moe: MoEConfig, xt):
    """One token pool. xt: (T, d) → (T, d), aux (a scalar)."""
    y, aux = _moe_rows(params, moe, xt[None])
    return y[0], aux[0]


def apply_moe(params, cfg: ArchConfig, x):
    """x: (B, S, d) → (B, S, d), aux (the mean of the rows' load-balance
    losses). Each batch row is its own capacity pool."""
    y, aux = _moe_rows(params, cfg.moe, x)
    y = shard(y, None, None, None)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x)
    return y, aux.mean()
