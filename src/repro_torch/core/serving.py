"""Serving step builders and the per-request greedy reference.

The port of ``src/repro/core/serving.py:22-69``. A prefill runs the prompt
through an empty KV cache (one flash-attention launch per layer); a serve
step decodes ONE new token per batch row against the cache (ring buffer of
the window for local layers). Sharded serving (``serve_shardings``) waits
for the sharding slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF


def build_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens) -> (logits, cache). tokens (B,1)."""

    def serve_step(params, cache, tokens):
        return TF.decode_step(params, cfg, tokens, cache)

    return serve_step


def build_prefill_step(cfg: ArchConfig):
    """prefill_step(params, cache, tokens) -> (logits, cache)."""

    def prefill_step(params, cache, tokens):
        return TF.prefill(params, cfg, tokens, cache)

    return prefill_step


def _top2_margin(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@torch.no_grad()
def greedy_decode(params, cfg: ArchConfig, prompt, n_steps: int,
                  max_len: int):
    """Simple reference decode loop (tests, ``chip_smoke.py``).

    The per-request ground truth the continuous-batching engine
    (``repro_torch.serve``) is checked against. prompt: (B, S) integer on
    the params' device; ``max_len`` sizes the KV cache and must cover
    prompt + generation. Returns the (B, n_steps) tokens and the
    (B, n_steps) gap between the top two logits each token was picked
    from (how close the pick was to a tie).
    """
    B = prompt.shape[0]
    cache = TF.init_cache(cfg, B, max_len, device=prompt.device)
    logits, cache = TF.prefill(params, cfg, prompt, cache)
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
