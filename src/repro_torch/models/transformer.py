"""Decoder LM assembled from an ArchConfig.

The port of ``src/repro/models/transformer.py:39-304`` for attention
layers (kinds ``G`` and ``L``: GQA or MLA, ``models/attention.py``) with
dense SwiGLU MLPs or MoE layers (``models/moe.py``; the first
``moe.n_dense_layers`` layers, the reference's ``head``, keep a dense
MLP), Mamba2 layers (kind ``M``, ``models/ssm.py``) and RG-LRU layers
(kind ``R``, ``models/rglru.py``, with a dense MLP). A frontend arch
(``cfg.frontend``: internvl2's patches, musicgen's frames) projects its
precomputed embeddings with ``proj_frontend`` and prepends them to the
text tokens (``_embed_tokens``). The JAX package
stacks each group of ``block_pattern`` layers for ``lax.scan``; here the
layers are a Python list in layer order (``params["layers"]``, one cache
per layer in ``cache["layers"]``). ``utils/convert.py`` maps a JAX tree
onto this layout.

Public API:
  init_params(cfg, seed=, device=)          -> params
  init_params_shape(cfg)                    -> params as meta tensors
  forward(params, cfg, tokens, frontend=None)        -> (logits, aux)
  init_cache(cfg, batch, max_len, dtype=, device=) -> cache
  prefill(params, cfg, tokens, cache, frontend=None) -> (logits, cache)
  decode_step(params, cfg, tokens, cache)   -> (logits, cache)

Training (``core/local_sgd.py``) keeps the parameters in the JAX
package's grouped layout — ``head`` / ``blocks`` / ``tail``, each
``blocks["sub<i>"]`` leaf stacked over the groups of ``block_pattern`` —
so that a communication round sees the reference's leaves (one int8 scale
per stacked leaf, the same per-leaf keys and bytes): ``to_grouped`` builds
it, ``layer_views`` reads it back as this module's per-layer layout, each
leaf a view of a group row, so gradients flow into the stacked leaves.
``forward`` is differentiable, and under grad each layer is rematerialised
in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does. ``forward``'s aux is the sum of the MoE layers'
load-balance losses (zero without MoE).

``cache["pos"]`` is a (B,) integer tensor: each batch row's token count,
so a batch of independent sequences (the serving engine's slots) decodes
in one call. An attention layer's cache holds K/V, a Mamba2 layer's its
conv carry and SSM state, an RG-LRU layer's conv carry and recurrent
state. The frontend tokens hold positions 0..n_fe − 1 and count in
``cache["pos"]``. Caches are updated in place; ``prefill`` fills
an empty cache (or a batch-row view of one, see ``cache_rows``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulate import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_mlp, rms_norm, softcap)
from repro_torch.sharding import shard
from repro_torch.sharding.rules import is_dtensor
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

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


def layer_views(grouped, cfg: ArchConfig):
    """The grouped layout (``head`` / ``blocks`` / ``tail``) → this module's
    layout: one dict per layer under ``layers``, each leaf a view of its
    group's row of a stacked ``blocks`` leaf (no copy).

    The rows come from one ``unbind`` a stacked leaf, not one index a
    group: under autograd a row's gradient then joins the others in one
    stack, where an index's backward would write a zero-filled copy of the
    whole stacked leaf for each group and add them up (at 64 layers, most
    of a step's memory traffic)."""
    _, n_groups, pattern, _ = _plan(cfg)
    out = {k: v for k, v in grouped.items()
           if k not in ("head", "blocks", "tail")}
    layers = list(grouped["head"])
    subs = []
    for i in range(len(pattern) if n_groups else 0):
        leaves, treedef = tree_flatten(grouped["blocks"][f"sub{i}"])
        subs.append((treedef, [torch.unbind(a, 0) for a in leaves]))
    for g in range(n_groups):
        for treedef, rows in subs:
            layers.append(treedef.unflatten([r[g] for r in rows]))
    layers += list(grouped["tail"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the grouped tree holds {len(layers)} "
                         f"layers, the config says {cfg.n_layers}")
    out["layers"] = layers
    return out


def to_grouped(params, cfg: ArchConfig):
    """This module's layout → the grouped one (the inverse of
    ``layer_views``); the ``blocks`` leaves are new stacked tensors."""
    head_kinds, n_groups, pattern, tail_kinds = _plan(cfg)
    layers = params["layers"]
    nh, p = len(head_kinds), len(pattern)
    body = layers[nh:nh + n_groups * p]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["head"] = list(layers[:nh])
    out["blocks"] = ({f"sub{i}": tree_map(lambda *xs: torch.stack(xs),
                                          *body[i::p]) for i in range(p)}
                     if n_groups else {})
    out["tail"] = list(layers[nh + n_groups * p:])
    return out


def check_supported(cfg: ArchConfig):
    """Raise for what this port does not build: unknown layer kinds, and
    grouped Mamba2 B/C, which the JAX model refuses too."""
    kinds = set(cfg.layer_kinds())
    bad = sorted(kinds - {"G", "L", "M", "R"})
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")
    if "M" in kinds:
        SSM.check_supported(cfg)
    if "R" in kinds:
        RG.check_supported(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _in_head(cfg: ArchConfig, i: int) -> bool:
    """Whether layer i is one of the leading dense layers of a MoE arch
    (the reference's ``head``)."""
    return i < len(_plan(cfg)[0])


def _init_layer(gen, cfg: ArchConfig, kind: str, in_head: bool, dtype):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=gen.device)
    if kind == "M":
        return {"ln1": zeros(), "mamba": SSM.init_mamba2(gen, cfg, dtype)}
    if kind == "R":
        return {"ln1": zeros(), "lru": RG.init_rglru(gen, cfg, dtype),
                "ln2": zeros(), "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}
    p = {"ln1": zeros(), "attn": A.init_attention(gen, cfg, dtype),
         "ln2": zeros()}
    if cfg.moe is not None and not in_head:
        p["moe"] = MOE.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int, device=None):
    """Random params on ``device`` (None means CUDA and raises without it).

    Each leaf is drawn in float32 from one seeded ``torch.Generator`` on
    that device and cast to ``cfg.dtype``. Draws differ from the JAX
    package's (threefry); tests carry JAX params across instead.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    return _build_params(torch.Generator(device=dev).manual_seed(seed), cfg)


class _NoDraws:
    """Stands in for the ``torch.Generator`` of ``_build_params`` where only
    shapes are wanted (a generator has no meta device): the init helpers
    allocate on its device, ``meta``, and draw nothing."""

    device = torch.device("meta")


def init_params_shape(cfg: ArchConfig):
    """The tree of ``init_params(cfg, ...)`` as meta tensors: shapes and
    types only, nothing allocated and nothing drawn (the counterpart of
    the JAX package's ``jax.eval_shape`` template)."""
    check_supported(cfg)
    return _build_params(_NoDraws(), cfg)


def _build_params(gen, cfg: ArchConfig):
    dev = gen.device
    dtype = getattr(torch, cfg.dtype)
    vp = padded_vocab(cfg)
    params = {"embed": embed_init(gen, vp, cfg.d_model, dtype),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, vp, dtype)
    if cfg.frontend:
        params["proj_frontend"] = dense_init(gen, cfg.frontend_dim,
                                             cfg.d_model, dtype)
    params["layers"] = [_init_layer(gen, cfg, kind, _in_head(cfg, i), dtype)
                        for i, kind in enumerate(cfg.layer_kinds())]
    return params


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg: ArchConfig, kind: str, x, pos_q, cache=None,
                 cache_pos=None, fresh=False):
    """Returns (x, aux): aux is the MoE layer's load-balance loss, else
    None."""
    if cfg.seq_parallel and cache is None:
        # the residual stream sequence-split over `model` between blocks
        x = shard(x, None, "model", None)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "M":
        out, _ = SSM.apply_mamba2(p["mamba"], cfg, h, cache=cache,
                                  fresh=fresh)
        return x + out, None
    if kind == "R":
        out, _ = RG.apply_rglru(p["lru"], cfg, h, cache=cache, fresh=fresh)
        x = x + out
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h2), None
    att_out, cache = A.apply_attention(p["attn"], cfg, h, pos_q,
                                       is_local=(kind == "L"), cache=cache,
                                       cache_pos=cache_pos)
    x = x + att_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        m, aux = MOE.apply_moe(p["moe"], cfg, h2)
        return x + m, aux
    return x + apply_mlp(p["mlp"], h2), None


def _run_stack(params, cfg: ArchConfig, x, pos_q, caches=None,
               cache_pos=None, fresh=False):
    """Returns (x, aux): aux sums the MoE layers' losses in layer order
    (a float32 zero without MoE)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.layer_kinds()):
        p = params["layers"][i]
        if caches is None and torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad
                                       for t in tree_leaves(p))):
            # remat: the backward recomputes the layer from its input, as
            # the reference's jax.checkpoint does
            x, aux = checkpoint(_apply_layer, p, cfg, kind, x, pos_q,
                                use_reentrant=False)
        else:
            c = caches[i] if caches is not None else None
            x, aux = _apply_layer(p, cfg, kind, x, pos_q, c, cache_pos,
                                  fresh)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _logits(params, cfg: ArchConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    if cfg.final_softcap is not None:
        if logits.requires_grad or is_dtensor(logits):
            # out of place: tanh saves its output for the backward (and a
            # DTensor may hold partial sums, which no in-place op takes)
            logits = softcap(logits, cfg.final_softcap)
        else:
            # cap * tanh(logits / cap), in place: the prefill logits of a
            # 256k vocabulary are gigabytes
            cap = cfg.final_softcap
            logits.div_(cap).tanh_().mul_(cap)
    vp = logits.shape[-1]
    if vp != cfg.vocab_size and is_dtensor(logits):
        # a vocab split over `model` (a DTensor has no slice fill): the
        # pad columns masked out of place
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, dtype=logits.dtype,
                                             device=logits.device), logits)
    elif vp != cfg.vocab_size:  # mask pad columns out of softmax/argmax
        logits[..., cfg.vocab_size:] = -1e30
    return shard(logits, None, None, "model")


def _embed_tokens(params, cfg: ArchConfig, tokens, frontend=None):
    """The scaled token embeddings, after the projected frontend
    embeddings (B, n_fe, frontend_dim) where a frontend arch is given
    them: cast to the activation type, projected, not scaled."""
    emb = params["embed"]
    # the JAX package multiplies by a weakly typed scalar, i.e. by
    # sqrt(d_model) rounded to the embedding's type
    x = emb[tokens] * torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype,
                                   device=emb.device)
    if cfg.frontend is not None and frontend is not None:
        fe = frontend.to(x.dtype) @ params["proj_frontend"]
        x = torch.cat([fe, x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, tokens, frontend=None):
    """Full-sequence scoring. tokens: (B, S) integer; ``frontend``: a
    frontend arch's (B, n_fe, frontend_dim) embeddings, or None. Returns
    (logits, aux), the logits over n_fe + S positions."""
    x = _embed_tokens(params, cfg, tokens, frontend)
    pos_q = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params, cfg, x, pos_q)
    return _logits(params, cfg, x), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Empty caches (``dtype``: a torch dtype, default ``cfg.dtype``) for
    ``batch`` independent rows on ``device`` (None means CUDA): K/V for an
    attention layer, the conv carry (in ``dtype``) and the float32 state
    for a Mamba2 or an RG-LRU layer."""
    return _build_cache(cfg, batch, max_len, dtype, resolve_device(device))


def init_cache_shape(cfg: ArchConfig, batch: int, max_len: int, dtype=None):
    """The tree of ``init_cache`` as meta tensors: shapes and types only,
    nothing allocated."""
    return _build_cache(cfg, batch, max_len, dtype, torch.device("meta"))


def _build_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, dev):
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype

    def layer(kind):
        if kind == "M":
            return SSM.init_mamba2_cache(cfg, batch, dtype, device=dev)
        if kind == "R":
            return RG.init_rglru_cache(cfg, batch, dtype, device=dev)
        return A.init_attention_cache(cfg, kind == "L", batch, max_len,
                                      dtype, device=dev)

    return {"pos": torch.zeros((batch,), dtype=torch.long, device=dev),
            "layers": [layer(kind) for kind in cfg.layer_kinds()]}


def cache_rows(cache, start: int, stop: int):
    """A view of batch rows [start, stop) of ``cache``: writing through it
    (``prefill``) writes the shared buffers in place."""
    return {"pos": cache["pos"][start:stop],
            "layers": [{k: buf[start:stop] for k, buf in c.items()}
                       for c in cache["layers"]]}


def prefill(params, cfg: ArchConfig, tokens, cache, frontend=None):
    """Run the prompt (B, S) through an empty cache; returns (logits, cache).

    A frontend arch's embeddings (``frontend``, (B, n_fe, frontend_dim))
    come first: the queries sit at positions 0..n_fe + S − 1 (prefill from
    zero, as in the JAX package), so every attention layer is one
    flash-attention launch and every Mamba2 layer one SSD-kernel launch. A
    reused cache (a retired slot of the serving engine) starts over: its
    positions are reset, its old K/V is masked as unwritten, and its conv
    carries and recurrent states (Mamba2's and RG-LRU's) are zeroed.
    """
    x = _embed_tokens(params, cfg, tokens, frontend)
    S = x.shape[1]
    pos_q = torch.arange(S, device=x.device)
    cache["pos"].zero_()
    for kind, c in zip(cfg.layer_kinds(), cache["layers"]):
        if kind in ("M", "R"):
            c["conv"].zero_()
            c["state"].zero_()
    # a one-token prompt takes the decode branch at position 0 (from the
    # zeroed state in a recurrent layer); a longer one scans from no state
    x, _ = _run_stack(params, cfg, x, pos_q, cache["layers"], cache["pos"],
                      fresh=True)
    cache["pos"].fill_(S)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, tokens, cache):
    """tokens: (B, 1). One decode step of every row against the cache."""
    x = _embed_tokens(params, cfg, tokens)
    cache_pos = cache["pos"]
    x, _ = _run_stack(params, cfg, x, cache_pos[:, None], cache["layers"],
                      cache_pos)
    cache["pos"].add_(1)
    return _logits(params, cfg, x), cache
