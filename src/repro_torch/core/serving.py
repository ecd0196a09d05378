"""Serving step builders and the per-request greedy reference.

The port of ``src/repro/core/serving.py:22-69``. A prefill runs the prompt
through an empty cache (one flash-attention launch per attention layer,
one SSD-kernel launch per Mamba2 layer), a frontend arch's embeddings
first; a serve step decodes ONE new token per batch row against the cache
(ring buffer of the window for local layers, the recurrent state update
for Mamba2 and RG-LRU layers). ``serve_shardings`` places a served model
on a device mesh: the parameters replicated over the data axes and split
on ``model`` by the sharding rules, the cache's batch (or, for a batch
too small to split, its sequence) over the data axes and its heads on
``model``, the tokens' batch over the data axes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF
from repro_torch.sharding.rules import (NamedSharding, P, cache_specs,
                                        feasible_specs, param_specs)
from repro_torch.utils.tree import tree_map


def build_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens) -> (logits, cache). tokens (B,1)."""

    def serve_step(params, cache, tokens):
        return TF.decode_step(params, cfg, tokens, cache)

    return serve_step


def build_prefill_step(cfg: ArchConfig):
    """prefill_step(params, cache, tokens, frontend=None) -> (logits,
    cache)."""

    def prefill_step(params, cache, tokens, frontend=None):
        return TF.prefill(params, cfg, tokens, cache, frontend)

    return prefill_step


def serve_shardings(cfg: ArchConfig, mesh, params_shape, cache_shape,
                    data_axes=("data",), seq_axes=()):
    """(params, cache, tokens) shardings (``NamedSharding`` trees) on
    ``mesh``, the rules' specs made feasible on it."""
    pspecs = feasible_specs(param_specs(params_shape), params_shape, mesh)
    cspecs = feasible_specs(cache_specs(cache_shape, data_axes=data_axes,
                                        seq_axes=seq_axes), cache_shape,
                            mesh)
    to_sh = lambda tree: tree_map(lambda s: NamedSharding(mesh, s), tree)
    tok = NamedSharding(mesh, P(tuple(data_axes) or None, None))
    return to_sh(pspecs), to_sh(cspecs), tok


def _top2_margin(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@torch.no_grad()
def greedy_decode(params, cfg: ArchConfig, prompt, n_steps: int,
                  max_len: int, frontend=None):
    """Simple reference decode loop (tests, ``chip_smoke.py``).

    The per-request ground truth the continuous-batching engine
    (``repro_torch.serve``) is checked against. prompt: (B, S) integer on
    the params' device; ``max_len`` sizes the KV cache and must cover
    prompt + generation (+ ``cfg.n_frontend_tokens`` when ``frontend``
    embeddings are passed: they occupy cache positions like text tokens).
    Returns the (B, n_steps) tokens and the
    (B, n_steps) gap between the top two logits each token was picked
    from (how close the pick was to a tie).
    """
    B = prompt.shape[0]
    cache = TF.init_cache(cfg, B, max_len, device=prompt.device)
    logits, cache = TF.prefill(params, cfg, prompt, cache, frontend)
    last = logits[:, -1:]
    del logits
    out, margins = [], []
    for i in range(n_steps):
        if i:
            last, cache = TF.decode_step(params, cfg, tok, cache)
        tok = torch.argmax(last, dim=-1)
        out.append(tok)
        margins.append(_top2_margin(last))
    return torch.cat(out, dim=1), torch.cat(margins, dim=1)
