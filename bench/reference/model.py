"""The plain reference model: the loss of one client's batch, float32.

Plain PyTorch, written from the architectures' equations, importing
nothing of the program. It computes the function the port's training
step computes (``models/transformer.py``'s decoder with Mamba2 layers or
GQA attention with SwiGLU MLPs, a frontend arch's projected frames before
the text tokens, tied embeddings, next-token cross-entropy over the
text), in float32 from the same weights:

* the embedding is scaled by sqrt(d_model) rounded to the weights' type,
  the constant of the port's (and the JAX package's) model;
* RMSNorm scales by 1 + s; RoPE rotates the two halves of each head;
* the SSD scan is the chunked dual form from a zero state;
* padded vocabulary columns are masked out of the softmax.

``mm`` is the matrix product every linear layer uses: ``torch.matmul``
for the reference, a float8 product for the control (``control.py``).
Each layer is recomputed in the backward (``torch.utils.checkpoint``), so
that a full-width model fits beside its float32 gradients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """x: (B, S, H, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q: (B, S, H, D); k, v: (B, S, KV, D), H a multiple of KV."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG)
    out = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v)
    return out.reshape(B, S, H, D)


def ssd_scan(x, dt, A, Bm, Cm, chunk):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, from h_0 = 0, in its chunked form.

    x: (b, S, H, P); dt: (b, S, H); A: (H,); Bm, Cm: (b, S, G, N)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    Q = min(chunk, S)
    pad = -S % Q
    if pad:
        z = lambda t: torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
        x, dt, Bh, Ch = z(x), z(dt), z(Bh), z(Ch)
    nc = x.shape[1] // Q
    x = x.reshape(b, nc, Q, H, P)
    dt = dt.reshape(b, nc, Q, H)
    Bh = Bh.reshape(b, nc, Q, H, N)
    Ch = Ch.reshape(b, nc, Q, H, N)
    a = torch.cumsum(dt * A, dim=2)                          # (b,c,Q,H)
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]          # (b,c,t,s,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      -math.inf))
    xdt = x * dt[..., None]
    cb = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh)
    y = torch.einsum("bctsh,bcshp->bcthp", cb * decay, xdt)
    to_end = torch.exp(a[:, :, -1:, :] - a)                  # (b,c,Q,H)
    states = torch.einsum("bcsh,bcshp,bcshn->bchpn", to_end, xdt, Bh)
    h = x.new_zeros((b, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(a[:, c, -1])[..., None, None] + states[:, c]
    prev = torch.stack(entering, dim=1)                      # (b,c,H,P,N)
    y = y + torch.einsum("bcthn,bchpn->bcthp", Ch, prev) \
        * torch.exp(a)[..., None]
    return y.reshape(b, nc * Q, H, P)[:, :S]


def mamba_layer(p, x, model, mm):
    s = model["ssm"]
    d_inner = s["expand"] * model["d_model"]
    H, P, N = d_inner // s["head_dim"], s["head_dim"], s["d_state"]
    gN = s["n_groups"] * N
    B_, S, _ = x.shape
    h = rms_norm(x, p["ln1"], model["norm_eps"])
    z, xs, Bc, Cc, dt = torch.split(mm(h, p["mamba.w_in"]),
                                    [d_inner, d_inner, gN, gN, H], dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    w = p["mamba.conv_w"]                                    # (K, ch)
    K = w.shape[0]
    padded = F.pad(conv_in, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + S] * w[i] for i in range(K))
    conv = F.silu(conv)
    xs = conv[..., :d_inner].reshape(B_, S, H, P)
    Bc = conv[..., d_inner:d_inner + gN].reshape(B_, S, s["n_groups"], N)
    Cc = conv[..., d_inner + gN:].reshape(B_, S, s["n_groups"], N)
    dt = F.softplus(dt + p["mamba.dt_bias"])
    A = -torch.exp(p["mamba.A_log"])
    y = ssd_scan(xs, dt, A, Bc, Cc, s["chunk_size"])
    y = y + xs * p["mamba.D"][None, None, :, None]
    y = rms_norm(y.reshape(B_, S, d_inner) * F.silu(z), p["mamba.ssm_norm"],
                 model["norm_eps"])
    return x + mm(y, p["mamba.w_out_ssm"])


def attention_layer(p, x, model, mm):
    a = model["attention"]
    B_, S, _ = x.shape
    H, KV, D = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    h = rms_norm(x, p["ln1"], model["norm_eps"])
    q = mm(h, p["attn.wq"]).reshape(B_, S, H, D)
    k = mm(h, p["attn.wk"]).reshape(B_, S, KV, D)
    v = mm(h, p["attn.wv"]).reshape(B_, S, KV, D)
    if a.get("qk_norm"):
        q = rms_norm(q, p["attn.q_norm"], model["norm_eps"])
        k = rms_norm(k, p["attn.k_norm"], model["norm_eps"])
    q, k = rope(q, a["rope_theta"]), rope(k, a["rope_theta"])
    x = x + mm(causal_attention(q, k, v).reshape(B_, S, H * D),
               p["attn.wo"])
    h = rms_norm(x, p["ln2"], model["norm_eps"])
    u = F.silu(mm(h, p["mlp.w_gate"])) * mm(h, p["mlp.w_up"])
    return x + mm(u, p["mlp.w_down"])


def embed_scale(model: dict) -> float:
    """sqrt(d_model) rounded to the weights' type."""
    return float(torch.tensor(math.sqrt(model["d_model"]),
                              dtype=getattr(torch, model["dtype"])))


def loss(params: dict, model: dict, tokens, labels, frontend=None,
         mm=torch.matmul):
    """Mean next-token cross-entropy of one client's batch: ``params``
    the float32 leaves by grouped path (the ``blocks.sub0.*`` leaves
    stacked over layers), ``tokens`` / ``labels`` (B, S), ``frontend``
    (B, n_fe, frontend_dim) or None."""
    x = params["embed"][tokens] * embed_scale(model)
    if frontend is not None:
        x = torch.cat([mm(frontend.float(), params["proj_frontend"]), x],
                      dim=1)
    kind = model["block_pattern"][0]
    layer = mamba_layer if kind == "M" else attention_layer
    pre = "blocks.sub0."
    # one unbind a stacked leaf: the layers' gradients then join in one
    # stack, where an index a layer would add up full-size zero-filled
    # copies of the leaf
    rows = {k[len(pre):]: torch.unbind(v, 0) for k, v in params.items()
            if k.startswith(pre)}
    for i in range(model["n_layers"]):
        p = {k: v[i] for k, v in rows.items()}
        x = checkpoint(layer, p, x, model, mm, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], model["norm_eps"])
    out = params["embed"] if model.get("tie_embeddings", True) else None
    logits = mm(x, out.t()) if out is not None else mm(x, params["unembed"])
    V = model["vocab_size"]
    if logits.shape[-1] > V:
        logits = torch.cat([logits[..., :V],
                            torch.full_like(logits[..., V:], NEG)], dim=-1)
    logits = logits[:, -labels.shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).mean()
