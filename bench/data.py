"""The inputs of a cell, made from ``--seed`` on the run's device.

Both sides get the same inputs from here: the program (through the
harness) and the plain reference. Nothing in this module imports the
program.

* Weights: one leaf a call, each from its own ``torch.Generator`` seeded
  from (seed, leaf path), drawn in the leaf's own type on the device. A
  leaf can so be drawn again alone, bit for bit, which is how the check
  gets the starting point back without keeping a copy of it.
* Batches: a Zipf unigram token stream (p(rank r) ∝ 1/r over the
  vocabulary, the recipe of the port's ``data/synthetic.make_token_stream``)
  drawn a local step at a time from a generator seeded from (seed, step),
  and a frontend arch's frame embeddings, standard normal in bfloat16.

Leaf paths name the port's grouped training layout (``embed``,
``blocks.sub0.mamba.w_in``, ...); every ``blocks`` leaf is stacked over
the layers.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

VOCAB_PAD = 256   # the embedding's rows are padded to a multiple of this


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for (seed, tags): any integer seed, the
    same on every machine."""
    h = hashlib.sha256(":".join(str(t) for t in (seed, *tags)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Leaf:
    path: str                 # dotted path in the grouped layout
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str                 # "normal" | "zeros" | "ones"
    std: float = 0.0


def mamba_dims(model: dict):
    """(d_inner, heads, conv channels, in-projection width) of a Mamba2
    layer."""
    s = model["ssm"]
    d_inner = s["expand"] * model["d_model"]
    heads = d_inner // s["head_dim"]
    gN = s["n_groups"] * s["d_state"]
    return d_inner, heads, d_inner + 2 * gN, 2 * d_inner + 2 * gN + heads


def leaf_specs(model: dict) -> List[Leaf]:
    """The leaves of one replica, in the grouped layout, with their init:
    a matrix (d_in, d_out) normal with std 1/sqrt(d_in), the embedding
    normal with std 0.02, norm scales zeros (they scale by 1 + s), and
    Mamba2's conv 0.1, A_log 0 (A = -1), D 1 and dt_bias 0, as the port
    initialises them."""
    dt = getattr(torch, model["dtype"])
    f32 = torch.float32
    d, L = model["d_model"], model["n_layers"]
    pattern = tuple(model["block_pattern"])
    if len(pattern) != 1 or pattern[0] not in ("M", "G"):
        raise ValueError(f"block pattern {pattern}: the benchmark builds "
                         f"one-kind stacks of 'M' or 'G' layers")
    vp = padded_vocab(model)
    leaves = [Leaf("embed", (vp, d), dt, "normal", 0.02),
              Leaf("final_norm", (d,), dt, "zeros")]
    if not model.get("tie_embeddings", True):
        leaves.append(Leaf("unembed", (d, vp), dt, "normal", d ** -0.5))
    if model.get("frontend"):
        fd = model["frontend_dim"]
        leaves.append(Leaf("proj_frontend", (fd, d), dt, "normal", fd ** -0.5))

    def mat(path, d_in, d_out):
        return Leaf(path, (L, d_in, d_out), dt, "normal", d_in ** -0.5)

    b = "blocks.sub0."
    leaves.append(Leaf(b + "ln1", (L, d), dt, "zeros"))
    if pattern[0] == "M":
        s = model["ssm"]
        d_inner, H, conv_ch, d_in_proj = mamba_dims(model)
        m = b + "mamba."
        leaves += [mat(m + "w_in", d, d_in_proj),
                   Leaf(m + "conv_w", (L, s["d_conv"], conv_ch), dt,
                        "normal", 0.1),
                   Leaf(m + "A_log", (L, H), f32, "zeros"),
                   Leaf(m + "D", (L, H), f32, "ones"),
                   Leaf(m + "dt_bias", (L, H), f32, "zeros"),
                   Leaf(m + "ssm_norm", (L, d_inner), dt, "zeros"),
                   mat(m + "w_out_ssm", d_inner, d)]
    else:
        a = model["attention"]
        if a["kind"] != "gqa":
            raise ValueError("the benchmark builds GQA attention layers")
        hq, hkv = a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
        leaves += [mat(b + "attn.wq", d, hq), mat(b + "attn.wk", d, hkv),
                   mat(b + "attn.wv", d, hkv), mat(b + "attn.wo", hq, d),
                   Leaf(b + "ln2", (L, d), dt, "zeros"),
                   mat(b + "mlp.w_gate", d, model["d_ff"]),
                   mat(b + "mlp.w_up", d, model["d_ff"]),
                   mat(b + "mlp.w_down", model["d_ff"], d)]
        if a.get("qk_norm"):
            leaves += [Leaf(b + "attn.q_norm", (L, a["head_dim"]), dt,
                            "zeros"),
                       Leaf(b + "attn.k_norm", (L, a["head_dim"]), dt,
                            "zeros")]
    return leaves


def make_leaf(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """One leaf from the seed: always the same tensor for (seed, path)."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    g = generator(device, seed, "weights", leaf.path)
    x = torch.randn(leaf.shape, generator=g, dtype=leaf.dtype, device=device)
    return x.mul_(leaf.std)


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {lf.path: make_leaf(lf, seed, device) for lf in leaf_specs(model)}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-exponent)
    return torch.cumsum(p, 0) / p.sum()


def frames(model: dict, traffic: dict) -> int:
    """Frontend frames a row: the traffic's, which must be the model's."""
    n = traffic.get("frontend_frames", 0)
    if bool(n) != bool(model.get("frontend")) or (
            n and n != model["n_frontend_tokens"]):
        raise ValueError(f"traffic frames {n} do not fit the model "
                         f"(frontend {model.get('frontend')}, "
                         f"{model.get('n_frontend_tokens')} frames)")
    return n


def make_batch(model: dict, traffic: dict, seed: int, step: int, device,
               cdf: torch.Tensor = None) -> dict:
    """Local step ``step``'s batch (1-based): tokens and labels (C, B, S)
    int64, the labels the next tokens; a frontend arch's frames (C, B,
    n_fe, frontend_dim) bfloat16."""
    C, B = traffic["clients"], traffic["rows_per_client"]
    S = traffic["tokens_per_row"]
    V = model["vocab_size"]
    if cdf is None:
        cdf = zipf_cdf(V, traffic.get("zipf_exponent", 1.0), device)
    g = generator(device, seed, "batch", step)
    u = torch.rand((C, B, S + 1), generator=g, dtype=torch.float64,
                   device=device)
    toks = torch.searchsorted(cdf, u).clamp_(max=V - 1)
    out = {"tokens": toks[..., :-1].contiguous(),
           "labels": toks[..., 1:].contiguous()}
    n_fe = frames(model, traffic)
    if n_fe:
        out["frontend"] = torch.randn(
            (C, B, n_fe, model["frontend_dim"]), generator=g,
            dtype=torch.bfloat16, device=device)
    return out


def tokens_per_step(traffic: dict) -> int:
    """Labelled tokens one local step trains on, over all clients."""
    return (traffic["clients"] * traffic["rows_per_client"]
            * traffic["tokens_per_row"])


def norm(x: torch.Tensor) -> float:
    """The 2-norm of a tensor of any type, in float64 over blocks of rows
    (no float32 copy of a whole large leaf)."""
    return math.sqrt(sum(float(torch.linalg.vector_norm(
        b.float(), dtype=torch.float64)) ** 2 for b in _blocks(x)))


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in float64, a block of rows at a time."""
    return math.sqrt(sum(float(torch.linalg.vector_norm(
        x.float() - y.float(), dtype=torch.float64)) ** 2
        for x, y in zip(_blocks(a), _blocks(b))))


def probe(x: torch.Tensor, seed: int, path: str) -> float:
    """<x, r> in float64, r standard normal from (seed, path), drawn a
    block of rows at a time on x's device: the same r for every tensor of
    x's shape, so <a, r> - <b, r> has the size of ||a - b|| whatever the
    pattern of a - b."""
    g = generator(x.device, seed, "probe", path)
    return sum(float((b.float() * torch.randn(b.shape, generator=g,
                                              device=b.device)).sum(
                                                  dtype=torch.float64))
               for b in _blocks(x))


def _blocks(x: torch.Tensor, limit: int = 1 << 25):
    if x.dim() == 0 or x.numel() <= limit:
        yield x
        return
    step = max(1, limit // max(1, x[0].numel()))
    for i in range(0, x.shape[0], step):
        yield x[i:i + step]
