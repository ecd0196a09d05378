"""Gradients through the port's transformer against the JAX package.

* The flash-attention autograd Function (``kernels/flash_attention/ops``)
  against ``jax.vjp`` of the reference's ``flash_attention(impl=
  "interpret")`` and its recompute custom VJP: the output within 1e-5
  (the softcap case scales q so that scores reach ±cap, which carries
  float32 rounding to 4e-6), dq, dk, dv within 2e-5 of the largest
  |gradient| (float32; both differentiate the same plain attention,
  summing float32 products in another order; measured ≤ 4e-6).
* ``local_sgd.lm_loss`` value (1e-5 relative) and gradients of every leaf
  (1e-5 of the leaf's largest |gradient|; measured ≤ 2e-6) on qwen3-14b
  and gemma2-27b SMOKE in float32, the JAX params carried across in the
  grouped layout. gemma2 covers the final softcap under autograd, the
  sliding window (80 tokens, window 64) and the attention softcap in the
  backward.
* The SSD scan refuses inputs that require grad (it has no backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import local_sgd as JLS
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models import transformer as JTF
from repro_torch.configs import get_arch
from repro_torch.core import local_sgd as TLS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models import transformer as TTF
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_flatten, tree_leaves

# (B, S, H, KV, D, causal, window, softcap)
FLASH_CASES = {
    "causal": (1, 128, 4, 4, 64, True, None, None),
    "gqa": (2, 128, 4, 2, 64, True, None, None),
    "window": (1, 256, 4, 2, 64, True, 32, None),
    "softcap": (1, 128, 4, 2, 64, True, None, 30.0),
    "full": (2, 128, 8, 2, 128, False, None, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_gradients_match_jax_custom_vjp(case):
    B, S, H, KV, D, causal, window, cap = FLASH_CASES[case]
    rng = np.random.RandomState(0)
    q = rng.randn(B, S, H, D).astype(np.float32)
    if cap:   # scores reach about +-cap, where the cap bends them
        q *= np.float32(cap / 4)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    want_out, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, window=window,
                                softcap=cap, impl="interpret"), q, k, v)
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ins, causal=causal, window=window, softcap=cap)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 2e-5, f"d{name}: {err}"


def test_flash_gradients_need_no_grad_on_every_input():
    """Only k requires grad: the Function returns its gradient alone."""
    rng = np.random.RandomState(1)
    q, v = (torch.from_numpy(rng.randn(1, 16, 2, 64).astype(np.float32))
            for _ in range(2))
    k = torch.from_numpy(rng.randn(1, 16, 2, 64).astype(np.float32))
    k.requires_grad_()
    (dk,) = torch.autograd.grad(flash_attention(q, k, v).sum(), [k])
    assert dk.shape == k.shape and bool(torch.isfinite(dk).all())


@pytest.fixture(scope="module", params=["qwen3-14b", "gemma2-27b"])
def model(request):
    name = request.param
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp


def test_lm_loss_and_gradients_match_jax(model):
    jcfg, tcfg, jp = model
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 81))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    want_loss, want = jax.value_and_grad(
        lambda p: JLS.lm_loss(p, jcfg, jb))(jp)
    tp = params_from_jax(to_numpy_tree(jp))
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    loss = TLS.lm_loss(tp, tcfg, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(got) == len(paths)
    for path, a, b in zip(paths, got, jax.tree.leaves(want)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= 1e-5, f"{path}: {err}"


def test_grouped_layout_round_trips(model):
    """``to_grouped`` and ``layer_views`` are inverse, and the views share
    the grouped tree's memory."""
    _, tcfg, jp = model
    grouped = params_from_jax(to_numpy_tree(jp))
    views = TTF.layer_views(grouped, tcfg)
    back = TTF.to_grouped(views, tcfg)
    for a, b in zip(tree_leaves(back), tree_leaves(grouped)):
        assert torch.equal(a, b)
    leaf = views["layers"][0]["attn"]["wq"]
    leaf.add_(1.0)
    assert torch.equal(grouped["blocks"]["sub0"]["attn"]["wq"][0], leaf)


def test_serving_logits_keep_the_in_place_softcap():
    """Without grad the final softcap runs in place and equals the
    autograd path's value."""
    cfg = get_arch("gemma2-27b", smoke=True).replace(dtype="float32")
    params = TTF.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 20))).long()
    with torch.no_grad():
        served, _ = TTF.forward(params, cfg, toks)
    for t in tree_leaves(params):
        t.requires_grad_()
    trained, _ = TTF.forward(params, cfg, toks)
    assert trained.grad_fn is not None and served.grad_fn is None
    np.testing.assert_allclose(trained.detach().numpy(), served.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_ssd_refuses_inputs_that_require_grad():
    b, S, H, P, G, N = 1, 8, 2, 4, 1, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, S, H, P), generator=g, requires_grad=True)
    dt = torch.rand((b, S, H), generator=g)
    A = -torch.rand((H,), generator=g)
    B, C = (torch.randn((b, S, G, N), generator=g) for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd(x, dt, A, B, C, chunk=4)
    with torch.no_grad():
        y, state = ssd(x, dt, A, B, C, chunk=4)
    y2, _ = ssd(x.detach(), dt, A, B, C, chunk=4)
    assert torch.equal(y, y2) and state.shape == (b, H, P, N)
