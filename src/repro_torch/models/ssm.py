"""Mamba2 block — SSD (state-space duality). [arXiv:2405.21060]

The port of ``src/repro/models/ssm.py:22-197``. A multi-token call (prefill,
scoring) runs the SSD scan in its chunked form through
``kernels.ssd.ops.ssd``: the Hopper kernel ``csrc/ssd.cu`` for a CUDA
tensor, the plain ``ssd_chunked_ref`` for a CPU one. Unlike the JAX model,
whose chunked scan asserts ``S % chunk == 0``, any prompt length is taken:
the last chunk may be short. A single-token call with a cache is the plain
recurrent update, batched over the cache's rows (the serving engine's
slots).

The cache holds the conv carry (the last ``d_conv - 1`` conv inputs) and
the SSM state (H, P, N) in float32: O(1) in the sequence length. It is
written in place, as the attention caches are. A multi-token call with a
cache continues from both, as the JAX model does: the conv from its carry,
the scan from ``cache["state"]`` as its initial state. So a prompt fed in
pieces ends where the whole prompt does. The transformer's ``prefill``
zeroes a reused row first and says so (``fresh``): its scan then takes
no initial state, the kernel's path without a state term, with the same
result.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import _normal, dense_init, rms_norm
from repro_torch.sharding import shard
from repro_torch.sharding.rules import (contiguous_grad, head_placements,
                                        is_dtensor, model_size)


def check_supported(cfg: ArchConfig):
    """Raise for what the Mamba2 block does not build, as the JAX model
    raises for grouped B/C (``src/repro/models/ssm.py:111-114``)."""
    if cfg.ssm is None:
        raise ValueError(f"{cfg.name}: layer kind 'M' needs an SSMConfig")
    if cfg.ssm.n_groups > 1:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 with n_groups > 1 is not built, as in the "
            f"JAX model (ROADMAP queue 1: grouped Mamba2 B/C)")


def _dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.n_groups * ssm.d_state
    d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + n_heads
    return d_inner, n_heads, conv_ch, d_in_proj


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype):
    ssm = cfg.ssm
    d_inner, n_heads, conv_ch, d_in_proj = _dims(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, cfg.d_model, d_in_proj, dtype),
        "conv_w": _normal(gen, (ssm.d_conv, conv_ch), 0.1, dtype),
        "A_log": torch.zeros((n_heads,), dtype=f32, device=dev),
        "D": torch.ones((n_heads,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=f32, device=dev),
        "ssm_norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_out_ssm": dense_init(gen, d_inner, cfg.d_model, dtype),
    }


def _split_in_proj(cfg: ArchConfig, zxbcdt):
    ssm = cfg.ssm
    d_inner, n_heads, _, _ = _dims(cfg)
    gN = ssm.n_groups * ssm.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gN, gN, n_heads], dim=-1)


def _causal_conv(x, w, carry=None):
    """Depthwise causal conv. x: (B,S,ch), w: (K,ch). carry: (B,K-1,ch) or
    None. Returns (silu(conv), the new carry)."""
    K = w.shape[0]
    if carry is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, ch)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out), xp[:, -(K - 1):]


def _ssd(x, dt, A, B, C, chunk, initial_state):
    """``ssd``; on DTensors (a client's forward on a mesh) on each rank's
    heads (``_ssd_on_shards``)."""
    if is_dtensor(x):
        return _ssd_on_shards(x, dt, A, B, C, chunk, initial_state)
    return ssd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)


def _ssd_on_shards(x, dt, A, B, C, chunk, initial_state):
    """The kernel's Function on each rank's heads, through ``local_map``
    (its saved tensors local): x, dt, A and the states split by heads on
    ``model`` where H divides, the one B/C group replicated (its gradient
    a partial sum over the ranks); otherwise every rank scans every
    head."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    split = x.shape[2] % model_size(x) == 0
    xp = head_placements(x, 2, split)
    ap = head_placements(A, 0, split, batch=False)
    bp = head_placements(B, 2, False)
    gbp = head_placements(B, 2, False, Partial() if split else None)
    sp = head_placements(x, 1, split)
    ins = (xp, xp, ap, bp, bp, None if initial_state is None else sp)
    grads = (xp, xp, ap, gbp, gbp, ins[5])

    def fn(x, dt, A, B, C, s0):
        x, dt, A, B, C, s0 = map(contiguous_grad, (x, dt, A, B, C, s0))
        return ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0)

    return local_map(fn, out_placements=(xp, sp), in_placements=ins,
                     in_grad_placements=grads, device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, dt, A, B, C, initial_state)


def apply_mamba2(params, cfg: ArchConfig, x, cache=None, fresh=False):
    """x: (B,S,d). cache: None or {"conv": (B,K-1,ch), "state": (B,H,P,N)},
    updated in place; ``fresh``: the caller has just zeroed the cache (a
    prefill), so the conv pads with zeros and the scan starts from no state
    instead of reading them. Returns (out (B,S,d), cache)."""
    check_supported(cfg)
    ssm = cfg.ssm
    d_inner, n_heads, _, _ = _dims(cfg)
    gN = ssm.n_groups * ssm.d_state
    B_, S, _ = x.shape
    zxbcdt = shard(x @ params["w_in"], None, None, "model")
    z, xs, Bc, Cc, dt = _split_in_proj(cfg, zxbcdt)

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_carry = None if cache is None or fresh else cache["conv"]
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_carry)
    xs = conv_out[..., :d_inner].reshape(B_, S, n_heads, ssm.head_dim)
    Bc = conv_out[..., d_inner:d_inner + gN].reshape(
        B_, S, ssm.n_groups, ssm.d_state)
    Cc = conv_out[..., d_inner + gN:].reshape(B_, S, ssm.n_groups,
                                             ssm.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if cache is None or S > 1:
        # the kernel's inputs: float32 and contiguous, so y is float32 as
        # the JAX model's is
        f32 = lambda t: t.float().contiguous()
        init = None if cache is None or fresh else f32(cache["state"])
        y, final_state = _ssd(f32(xs), dt.contiguous(), A.contiguous(),
                              f32(Bc), f32(Cc), ssm.chunk_size, init)
    else:
        # single-token recurrent decode: state' = exp(dt·A)·state + dt·x Bᵀ
        st = cache["state"].float()                          # (B,H,P,N)
        dA1 = torch.exp(dt[:, 0] * A[None, :])               # (B,H)
        xb = torch.einsum("bhp,bgn->bhpn",
                          (xs[:, 0] * dt[:, 0, :, None]).float(),
                          Bc[:, 0].float())
        final_state = st * dA1[..., None, None] + xb
        y = torch.einsum("bhpn,bgn->bhp", final_state,
                         Cc[:, 0].float())[:, None]

    y = y + xs.float() * params["D"][None, None, :, None]
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["ssm_norm"],
                 cfg.norm_eps)
    out = y @ params["w_out_ssm"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(final_state)
    return out, cache


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype, device=None):
    ssm = cfg.ssm
    d_inner, n_heads, conv_ch, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, ssm.head_dim, ssm.d_state),
                             dtype=torch.float32, device=device),
    }
