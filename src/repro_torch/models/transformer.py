"""Decoder LM assembled from an ArchConfig.

The port of ``src/repro/models/transformer.py:39-304`` for attention
layers (kinds ``G`` and ``L``) with dense SwiGLU MLPs. The JAX package
stacks each group of ``block_pattern`` layers for ``lax.scan``; here the
layers are a Python list in layer order (``params["layers"]``, one cache
per layer in ``cache["layers"]``). ``utils/convert.py`` maps a JAX tree
onto this layout.

Public API:
  init_params(cfg, seed=, device=)          -> params
  forward(params, cfg, tokens)              -> (logits, aux)   # scoring
  init_cache(cfg, batch, max_len, dtype=, device=) -> cache
  prefill(params, cfg, tokens, cache)       -> (logits, cache)
  decode_step(params, cfg, tokens, cache)   -> (logits, cache)

``cache["pos"]`` is a (B,) integer tensor: each batch row's token count,
so a batch of independent sequences (the serving engine's slots) decodes
in one call. Caches are updated in place; ``prefill`` fills an empty
cache (or a batch-row view of one, see ``cache_rows``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulate import resolve_device
from repro_torch.models import attention as A
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_mlp, rms_norm)

VOCAB_PAD = 256  # embedding rows padded as in the JAX package


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _plan(cfg: ArchConfig):
    """Split layers into (head_kinds, n_groups, pattern, tail_kinds), the
    JAX package's layout (kept for ``utils/convert.py``)."""
    kinds = cfg.layer_kinds()
    n_head = cfg.moe.n_dense_layers if cfg.moe else 0
    body = kinds[n_head:]
    p = len(cfg.block_pattern)
    n_groups = len(body) // p
    tail = body[n_groups * p:]
    return kinds[:n_head], n_groups, cfg.block_pattern, tail


def check_supported(cfg: ArchConfig):
    """Raise for what this port cannot build yet, naming its ROADMAP item."""
    bad = sorted(set(cfg.layer_kinds()) - {"G", "L"})
    if bad:
        what = {"M": "Mamba2 layers with the ssd kernel",
                "R": "RG-LRU layers"}
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} are not ported yet (ROADMAP "
            f"queue 1: {', '.join(what.get(b, b) for b in bad)})")
    if cfg.moe is not None:
        raise A._not_ported("MoE")
    if cfg.attention is None or cfg.attention.kind != "gqa":
        raise A._not_ported("MLA")
    if cfg.kv_quant:
        raise A._not_ported("kv_quant")
    if cfg.frontend is not None:
        raise A._not_ported("frontend archs")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ArchConfig, dtype):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=gen.device)
    return {"ln1": zeros(), "attn": A.init_attention(gen, cfg, dtype),
            "ln2": zeros(), "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}


def init_params(cfg: ArchConfig, *, seed: int, device=None):
    """Random params on ``device`` (None means CUDA and raises without it).

    Each leaf is drawn in float32 from one seeded ``torch.Generator`` on
    that device and cast to ``cfg.dtype``. Draws differ from the JAX
    package's (threefry); tests carry JAX params across instead.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = padded_vocab(cfg)
    params = {"embed": embed_init(gen, vp, cfg.d_model, dtype),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, vp, dtype)
    params["layers"] = [_init_layer(gen, cfg, dtype)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg: ArchConfig, kind: str, x, pos_q, cache=None,
                 cache_pos=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att_out, cache = A.apply_attention(p["attn"], cfg, h, pos_q,
                                       is_local=(kind == "L"), cache=cache,
                                       cache_pos=cache_pos)
    x = x + att_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h2)


def _run_stack(params, cfg: ArchConfig, x, pos_q, caches=None,
               cache_pos=None):
    for i, kind in enumerate(cfg.layer_kinds()):
        c = caches[i] if caches is not None else None
        x = _apply_layer(params["layers"][i], cfg, kind, x, pos_q, c,
                         cache_pos)
    return x


def _logits(params, cfg: ArchConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    if cfg.final_softcap is not None:
        # cap * tanh(logits / cap), in place: the prefill logits of a
        # 256k vocabulary are gigabytes
        cap = cfg.final_softcap
        logits.div_(cap).tanh_().mul_(cap)
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:  # mask pad columns out of softmax/argmax
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _embed_tokens(params, cfg: ArchConfig, tokens):
    emb = params["embed"]
    # the JAX package multiplies by a weakly typed scalar, i.e. by
    # sqrt(d_model) rounded to the embedding's type
    return emb[tokens] * torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype,
                                      device=emb.device)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, tokens):
    """Full-sequence scoring. tokens: (B, S) integer. Returns (logits, aux)."""
    x = _embed_tokens(params, cfg, tokens)
    pos_q = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(params, cfg, x, pos_q)
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Empty KV caches (``dtype``: a torch dtype, default ``cfg.dtype``)
    for ``batch`` independent rows on ``device`` (None means CUDA)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    return {"pos": torch.zeros((batch,), dtype=torch.long, device=dev),
            "layers": [A.init_attention_cache(cfg, kind == "L", batch,
                                              max_len, dtype, device=dev)
                       for kind in cfg.layer_kinds()]}


def cache_rows(cache, start: int, stop: int):
    """A view of batch rows [start, stop) of ``cache``: writing through it
    (``prefill``) writes the shared buffers in place."""
    return {"pos": cache["pos"][start:stop],
            "layers": [{k: buf[start:stop] for k, buf in c.items()}
                       for c in cache["layers"]]}


def prefill(params, cfg: ArchConfig, tokens, cache):
    """Run the prompt (B, S) through an empty cache; returns (logits, cache).

    The queries sit at positions 0..S-1 (prefill from zero, as in the JAX
    package), so every layer's attention is one flash-attention launch.
    A reused cache (a retired slot of the serving engine) starts over:
    its positions are reset, and its old K/V is masked as unwritten.
    """
    x = _embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    pos_q = torch.arange(S, device=x.device)
    cache["pos"].zero_()
    # a one-token prompt takes the decode branch at position 0
    x = _run_stack(params, cfg, x, pos_q, cache["layers"], cache["pos"])
    cache["pos"].fill_(S)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, tokens, cache):
    """tokens: (B, 1). One decode step of every row against the cache."""
    x = _embed_tokens(params, cfg, tokens)
    cache_pos = cache["pos"]
    x = _run_stack(params, cfg, x, cache_pos[:, None], cache["layers"],
                   cache_pos)
    cache["pos"].add_(1)
    return _logits(params, cfg, x), cache
