"""The port's flash attention and GQA layer against the JAX package.

On the CPU the port's ``flash_attention`` takes its plain version; the
same numpy inputs go through the JAX package's Pallas kernel in interpret
mode, on ``tests/test_kernels.py``'s shapes, masks and tolerances (2e-6 in
float32: both sum float32 products in another order; 2e-2 in bfloat16:
the output is rounded to bfloat16). Ragged shapes, which the Pallas
kernel's block grid does not take, are held to the JAX ``attention_ref``.
The GQA layer (full sequence, prefill, decode with a ring wrap) is held to
JAX's ``apply_gqa`` at smoke width to 1e-5 (float32 matmuls and softmax
in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import attention as JA
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     bf16_mismatch)
from repro_torch.models import attention as TA
from repro_torch.utils.convert import params_from_jax

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, Sq, Sk, H, KV, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = _DT[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


SHAPES = [
    (1, 128, 4, 4, 64),    # MHA
    (2, 256, 4, 2, 64),    # GQA
    (1, 256, 8, 1, 128),   # MQA, MXU-width head
    (2, 512, 2, 2, 128),   # longer sequence
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(shape, dtype):
    B, S, H, KV, D = shape
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(B, S, S, H, KV, D), dtype)
    want = j_flash(qj, kj, vj, impl="interpret")
    got = flash_attention(qt, kt, vt)
    assert got.dtype == _DT[dtype][1] and got.shape == (B, S, H, D)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_flash_attention_masks_match_jax_kernel(window, softcap):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(1, 256, 256, 4, 2, 64),
                                       "float32")
    want = j_flash(qj, kj, vj, window=window, softcap=softcap,
                   impl="interpret")
    got = flash_attention(qt, kt, vt, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_flash_attention_noncausal_matches_jax_kernel():
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(1, 128, 128, 2, 2, 64),
                                       "float32")
    want = j_flash(qj, kj, vj, causal=False, impl="interpret")
    got = flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


# (Sq, Sk, window, softcap): ragged lengths and queries at the kv tail
RAGGED = [(200, 200, None, None), (200, 200, 64, 50.0), (3, 130, 32, None),
          (1, 77, None, 30.0)]


@pytest.mark.parametrize("sq,sk,window,softcap", RAGGED)
def test_flash_attention_ragged_matches_jax_ref(sq, sk, window, softcap):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(1, sq, sk, 4, 2, 64, seed=3),
                                       "float32")
    want = j_ref(qj, kj, vj, window=window, softcap=softcap)
    got = flash_attention(qt, kt, vt, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def _bf16_kernel_model(q, k, v, window, softcap, mutation):
    """What the bfloat16 CUDA kernel computes, rounding included: float32
    scores and row sums, probabilities rounded to bfloat16 for P.V, the
    output rounded to bfloat16; ``mutation`` breaks it as a kernel bug
    would (a kv tile skipped for late rows, a window one key too wide)."""
    S = q.shape[1]
    i, j = torch.arange(S)[:, None], torch.arange(S)[None]
    wide = window + (1 if mutation == "window+1" else 0)
    ok = (j <= i) & (j > i - wide)
    if mutation == "drop_tile":
        ok &= ~((i >= S // 2) & (j >= 64) & (j < 128))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) / q.shape[-1] ** 0.5
    s = (softcap * torch.tanh(s / softcap)).masked_fill(~ok, -1e38)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                       v.float()) / p.sum(-1)[..., None].transpose(1, 2)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("mutation", [None, "drop_tile", "window+1"])
def test_bf16_tolerance_passes_the_kernels_rounding_and_fails_its_bugs(
        mutation):
    """ref.py's bf16 tolerance (what the card holds the kernel to) admits
    the rounding a correct kernel does at a gemma2-like shape (D = 128,
    window and softcap), and its per-row check rejects a skipped kv tile
    and an off-by-one window."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 768, 768, 8, 8, 128, seed=5))
    ref = attention_ref(q, k, v, window=512, softcap=50.0)
    out = _bf16_kernel_model(q, k, v, 512, 50.0, mutation)
    err, elem, row = bf16_mismatch(out, ref)
    if mutation is None:
        assert elem <= 1.0 and row <= 1.0, (err, elem, row)
    else:
        assert row > 1.0, (err, elem, row)


@pytest.mark.parametrize("bad", ["heads", "sq_gt_sk", "k_shape", "rank"])
def test_flash_attention_rejects_bad_shapes(bad):
    q, k, v = (torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
               torch.zeros(1, 8, 2, 64))
    if bad == "heads":
        k, v = torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64)
    elif bad == "sq_gt_sk":
        k, v = k[:, :4], v[:, :4]
    elif bad == "k_shape":
        k = torch.zeros(1, 8, 2, 32)
    else:
        q = q[0]
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    with pytest.raises(ValueError):        # the kernel wrapper: CUDA only
        FK.flash_attention(torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
                           torch.zeros(1, 8, 2, 64))


# -- the GQA layer -----------------------------------------------------------

def _layer(name, seed=0):
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    import jax

    jp = JA.init_attention(jax.random.key(seed), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ["gemma2-27b", "qwen3-14b"])
@pytest.mark.parametrize("is_local", [True, False])
def test_apply_gqa_full_sequence_matches_jax(name, is_local):
    jcfg, tcfg, jp, tp = _layer(name)
    x = np.random.RandomState(1).randn(2, 80, jcfg.d_model).astype(np.float32)
    pos = np.arange(80, dtype=np.int32)
    want, _ = JA.apply_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 is_local=is_local)
    got, cache = TA.apply_attention(tp, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(pos).long(),
                                    is_local=is_local)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["gemma2-27b", "qwen3-14b"])
def test_apply_gqa_prefill_then_decode_with_ring_wrap_matches_jax(name):
    """Local layer, window 64 (gemma2) / the sliding-window variant
    (qwen3): an 80-token prefill rolls the ring, then decode steps write
    at their own ring slots past the window."""
    jcfg, tcfg, jp, tp = _layer(name)
    att = jcfg.attention
    if att.window is None:
        jcfg = jcfg.replace(attention=att.__class__(
            **{**att.__dict__, "window": 64}))
        tcfg = tcfg.replace(attention=tcfg.attention.__class__(
            **{**tcfg.attention.__dict__, "window": 64}))
    B, S, n_dec, max_len = 2, 80, 6, 100
    rng = np.random.RandomState(2)
    x = rng.randn(B, S + n_dec, jcfg.d_model).astype(np.float32)
    jc = JA.init_attention_cache(jcfg, True, B, max_len, jnp.float32)
    tc = TA.init_attention_cache(tcfg, True, B, max_len, torch.float32)
    assert tc["k"].shape == (B, 64, att.n_kv_heads, att.head_dim)
    pos = np.arange(S, dtype=np.int32)
    want, jc = JA.apply_attention(jp, jcfg, jnp.asarray(x[:, :S]),
                                  jnp.asarray(pos), is_local=True, cache=jc,
                                  cache_pos=jnp.int32(0))
    got, tc = TA.apply_attention(tp, tcfg, torch.from_numpy(x[:, :S]),
                                 torch.from_numpy(pos).long(), is_local=True,
                                 cache=tc, cache_pos=torch.zeros(B).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for i in range(n_dec):
        p = S + i
        want, jc = JA.apply_attention(
            jp, jcfg, jnp.asarray(x[:, p:p + 1]), jnp.asarray([p], jnp.int32),
            is_local=True, cache=jc, cache_pos=jnp.int32(p))
        got, tc = TA.apply_attention(
            tp, tcfg, torch.from_numpy(x[:, p:p + 1]),
            torch.full((B, 1), p), is_local=True, cache=tc,
            cache_pos=torch.full((B,), p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, rtol=1e-5)


def test_decode_rows_keep_their_own_positions():
    """One decode call over rows at different positions equals each row
    decoded alone (the serving engine's slot batch)."""
    _, tcfg, _, tp = _layer("gemma2-27b")
    att = tcfg.attention
    rng = np.random.RandomState(4)
    caches = TA.init_attention_cache(tcfg, True, 3, 100, torch.float32)
    caches["k"].copy_(torch.from_numpy(
        rng.randn(*caches["k"].shape).astype(np.float32)))
    caches["v"].copy_(torch.from_numpy(
        rng.randn(*caches["v"].shape).astype(np.float32)))
    pos = torch.tensor([5, 63, 130])            # before, at, past the wrap
    x = torch.from_numpy(rng.randn(3, 1, tcfg.d_model).astype(np.float32))
    alone = []
    for r in range(3):
        c = {k: v[r:r + 1].clone() for k, v in caches.items()}
        out, _ = TA.apply_gqa(tp, att, x[r:r + 1], pos[r:r + 1, None],
                              window=att.window, eps=tcfg.norm_eps, cache=c,
                              cache_pos=pos[r:r + 1])
        alone.append(out)
    both, _ = TA.apply_gqa(tp, att, x, pos[:, None], window=att.window,
                           eps=tcfg.norm_eps, cache=caches, cache_pos=pos)
    np.testing.assert_allclose(both.numpy(), torch.cat(alone).numpy(),
                               atol=1e-6, rtol=1e-6)


def test_cache_positions_match_jax():
    for C, p in ((8, 0), (8, 5), (8, 7), (8, 8), (8, 21)):
        want = np.asarray(JA._cache_positions(C, jnp.int32(p)))
        got = TA._cache_positions(C, torch.tensor([p]))[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_mla_and_kv_quant_raise_with_their_roadmap_item():
    att = get_arch("gemma2-27b", smoke=True).attention
    cfg = get_arch("gemma2-27b", smoke=True)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        TA.init_attention_cache(cfg.replace(kv_quant=True), True, 1, 8,
                                torch.float32)
    with pytest.raises(NotImplementedError, match="MLA"):
        TA.apply_attention({}, cfg.replace(attention=att.__class__(
            **{**att.__dict__, "kind": "mla"})), torch.zeros(1, 2, 256),
            torch.arange(2), is_local=False)
