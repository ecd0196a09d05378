"""The port's transformer against the JAX package at smoke width.

gemma2-27b (local + global layers, window 64, both softcaps, tied
embeddings) and qwen3-14b (qk_norm, untied) SMOKE configs in float32; the
JAX package's random params are carried across by
``transformer_params_from_jax``, so both packages compute the same
function. Logits agree to 1e-4 (float32 matmuls, softmax and rsqrt in
another order through two layers; the logits are at most 30 after the
final softcap), and greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.core.serving import greedy_decode as j_greedy
from repro.launch import flops as JF
from repro.models import transformer as JTF
from repro_torch.configs import SHAPES, get_arch
from repro_torch.core import serving as TS
from repro_torch.launch import flops as TFL
from repro_torch.models import transformer as TTF
from repro_torch.utils.convert import transformer_params_from_jax

ARCHS = ["gemma2-27b", "qwen3-14b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    jcfg = jax_get_arch(name, smoke=True).replace(dtype="float32")
    tcfg = get_arch(name, smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 80)
    want, _ = JTF.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TTF.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert got.shape == (2, 80, TTF.padded_vocab(tcfg)) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_prefill_and_decode_past_the_window_match_jax(model):
    """An 80-token prompt (longer than gemma2's window of 64) then 12
    decode steps: the local layers' ring wraps in both."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 80, seed=1)
    jc = JTF.init_cache(jcfg, 2, 100)
    tc = TTF.init_cache(tcfg, 2, 100, device="cpu")
    want, jc = JTF.prefill(jp, jcfg, jnp.asarray(toks), jc)
    got, tc = TTF.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    for _ in range(12):
        want, jc = JTF.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        got, tc = TTF.decode_step(tp, tcfg, torch.from_numpy(tok.copy())
                                  .long(), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(want, axis=-1))
    assert tc["pos"].tolist() == [92, 92] and int(jc["pos"]) == 92


def test_greedy_decode_tokens_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens(jcfg, 1, 70, seed=2)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(prompt), 10, 96))
    got, margins = TS.greedy_decode(tp, tcfg, torch.from_numpy(prompt).long(),
                                    10, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    assert margins.shape == (1, 10) and bool((margins >= 0).all())


def test_one_token_prompt_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens(jcfg, 1, 1, seed=3)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(prompt), 4, 16))
    got, _ = TS.greedy_decode(tp, tcfg, torch.from_numpy(prompt).long(), 4,
                              16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_through_a_row_view_writes_the_shared_cache(model):
    _, tcfg, _, tp = model
    stacked = TTF.init_cache(tcfg, 3, 100, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 1, 20, seed=4)).long()
    TTF.prefill(tp, tcfg, toks, TTF.cache_rows(stacked, 1, 2))
    alone = TTF.init_cache(tcfg, 1, 100, device="cpu")
    TTF.prefill(tp, tcfg, toks, alone)
    assert stacked["pos"].tolist() == [0, 20, 0]
    for c, a in zip(stacked["layers"], alone["layers"]):
        assert torch.equal(c["k"][1:2], a["k"])
        assert not c["k"][0].any() and not c["k"][2].any()


def test_init_params_layout_matches_jax():
    for name in ARCHS:
        jcfg = jax_get_arch(name, smoke=True)
        tcfg = get_arch(name, smoke=True)
        jp = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                          JTF.init_params_shape(jcfg))
        want = transformer_params_from_jax(jp, tcfg, "cpu")
        got = TTF.init_params(tcfg, seed=0, device="cpu")
        flat = lambda t: sorted(
            (k, tuple(v.shape)) for k, v in _flatten(t).items())
        assert flat(got) == flat(want)
        assert got["embed"].dtype == torch.bfloat16
        again = TTF.init_params(tcfg, seed=0, device="cpu")
        assert torch.equal(got["layers"][1]["mlp"]["w_up"],
                           again["layers"][1]["mlp"]["w_up"])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    cfg = get_arch("gemma2-27b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTF.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTF.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b", "internvl2-2b",
                                  "recurrentgemma-2b"])
def test_unported_archs_raise_naming_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch(name)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_unported_layer_kinds_raise():
    cfg = get_arch("gemma2-27b", smoke=True)
    for bad in (cfg.replace(block_pattern=("M",)),
                cfg.replace(block_pattern=("G", "R"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TTF.init_params(bad, seed=0, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_flops_model_equals_jax(name, smoke):
    jcfg, tcfg = jax_get_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
    assert TFL.count_params(tcfg) == JF.count_params(jcfg)
    for key in SHAPES:
        a = TFL.shape_flops(tcfg, SHAPES[key])
        b = JF.shape_flops(jcfg, J_SHAPES[key])
        assert (a.step_flops, a.hbm_bytes, a.model_flops) == \
            (b.step_flops, b.hbm_bytes, b.model_flops)
    for S, w, kind in ((4608, 4096, "full"), (4608, None, "full"),
                       (100, 64, "decode")):
        assert TFL._attn_pairs(S, w, kind) == JF._attn_pairs(S, w, kind)
