"""The port's SSD scan and Mamba2 model against the JAX package.

On the CPU the port's ``kernels.ssd.ops.ssd`` takes its plain chunked
version; the same numpy inputs go through the JAX package's Pallas kernel
in interpret mode and its sequential oracle ``ssd_ref``, on
``tests/test_ssd_kernel.py``'s shapes and tolerances (3e-4 in float32, 5e-2
with bfloat16 inputs). Ragged lengths, which neither the Pallas kernel nor
the JAX model's chunked scan take, are held to the JAX ``ssd_ref`` and to
the JAX model fed token by token through ``decode_step``. The model
(mamba2-2.7b SMOKE in float32, JAX params carried across by
``transformer_params_from_jax``) is held to 1e-4 in its logits (float32
matmuls and scans in another order through two layers) with greedy tokens
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.serving import greedy_decode as j_greedy
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.models import ssm as JSSM
from repro.models import transformer as JTF
from repro_torch.configs import get_arch
from repro_torch.core import serving as TS
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TTF
from repro_torch.utils.convert import (params_from_jax,
                                       transformer_params_from_jax)

TOL = dict(atol=3e-4, rtol=3e-4)


def _inputs(b, S, H, P, G, N, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, S, H, P) * 0.5).astype(np.float32)
    dt = (np.logaddexp(rng.randn(b, S, H), 0.0) * 0.1).astype(np.float32)
    A = (-np.exp(rng.randn(H) * 0.3)).astype(np.float32)
    B = (rng.randn(b, S, G, N) * 0.3).astype(np.float32)
    C = (rng.randn(b, S, G, N) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _jax(arrays, dtype=jnp.float32):
    x, dt, A, B, C = (jnp.asarray(a) for a in arrays)
    return x.astype(dtype), dt, A, B.astype(dtype), C.astype(dtype)


def _torch(arrays, dtype=torch.float32):
    x, dt, A, B, C = (torch.from_numpy(a.copy()) for a in arrays)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


@pytest.mark.parametrize("shape", [
    (1, 128, 2, 32, 1, 16),
    (2, 256, 4, 64, 1, 32),
    (1, 256, 4, 64, 2, 32),   # grouped B/C (G=2)
])
@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_matches_pallas_interpret_and_ref(shape, chunk):
    arrays = _inputs(*shape)
    yk, sk = j_ssd(*_jax(arrays), chunk=chunk, impl="interpret")
    yr, sr = j_ssd_ref(*_jax(arrays))
    y, st = ssd(*_torch(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == sk.shape
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **TOL)


def test_ssd_bf16_inputs_match_pallas_interpret():
    arrays = _inputs(1, 128, 2, 64, 1, 32)
    yk, _ = j_ssd(*_jax(arrays, jnp.bfloat16), chunk=64, impl="interpret")
    y, _ = ssd(*_torch(arrays, torch.bfloat16), chunk=64)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yk, np.float32), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("S", [100, 200])
@pytest.mark.parametrize("G", [1, 2])
def test_ragged_ssd_matches_jax_ref(S, G):
    """S not a multiple of the chunk (64): a short last chunk."""
    arrays = _inputs(2, S, 4, 32, G, 16, seed=S)
    yr, sr = j_ssd_ref(*_jax(arrays))
    y, st = ssd(*_torch(arrays), chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)


@pytest.mark.parametrize("S", [100, 200])
def test_ssd_ref_with_initial_state_matches_jax(S):
    arrays = _inputs(2, S, 2, 32, 1, 16, seed=S + 1)
    init = (np.random.RandomState(9).randn(2, 2, 32, 16) * 0.2) \
        .astype(np.float32)
    yr, sr = j_ssd_ref(*_jax(arrays), initial_state=jnp.asarray(init))
    y, st = ssd_ref(*_torch(arrays), initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)


@pytest.mark.parametrize("S, chunk", [(100, 64), (200, 64), (37, 64)])
@pytest.mark.parametrize("G", [1, 2])
def test_chunked_scan_from_an_initial_state_matches_jax_ref(S, chunk, G):
    """The chunked scan continues from a given state: the CPU route of
    ``ssd`` (``ssd_chunked_ref``) against JAX's ``ssd_ref`` and the port's
    sequential ``ssd_ref`` with the same initial state, at ragged S."""
    arrays = _inputs(2, S, 4, 32, G, 16, seed=S + G)
    init = (np.random.RandomState(S).randn(2, 4, 32, 16) * 0.5) \
        .astype(np.float32)
    yj, sj = j_ssd_ref(*_jax(arrays), initial_state=jnp.asarray(init))
    x, dt, A, B, C = _torch(arrays)
    t_init = torch.from_numpy(init.copy())
    y, st = ssd(x, dt, A, B, C, chunk=chunk, initial_state=t_init)
    yc, sc = ssd_chunked_ref(x, dt, A, B, C, chunk, t_init)
    yr, sr = ssd_ref(x, dt, A, B, C, initial_state=t_init)
    assert torch.equal(t_init, torch.from_numpy(init))    # read, not written
    assert torch.equal(y, yc) and torch.equal(st, sc)
    for want_y, want_s in ((yj, sj), (yr.numpy(), sr.numpy())):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **TOL)
    # control: the state matters at these inputs
    y0, _ = ssd(x, dt, A, B, C, chunk=chunk)
    assert not np.allclose(y0.numpy(), np.asarray(yj), **TOL)


def test_chunked_ref_short_chunk_equals_the_recurrence():
    """One chunk shorter than Q, and a chunk of one row."""
    for S, chunk in ((37, 64), (5, 1)):
        x, dt, A, B, C = _torch(_inputs(1, S, 2, 16, 1, 16, seed=S))
        y, st = ssd_chunked_ref(x, dt, A, B, C, chunk)
        yr, sr = ssd_ref(x, dt, A, B, C)
        torch.testing.assert_close(y, yr, **TOL)
        torch.testing.assert_close(st, sr, **TOL)


def test_ssd_refuses_shapes_the_scan_does_not_define():
    x, dt, A, B, C = _torch(_inputs(1, 64, 4, 32, 2, 16))
    with pytest.raises(ValueError):                      # 3 groups, 4 heads
        ssd(x, dt, A, torch.zeros(1, 64, 3, 16), torch.zeros(1, 64, 3, 16))
    with pytest.raises(ValueError):                      # dt of another S
        ssd(x, dt[:, :32], A, B, C)
    with pytest.raises(ValueError):                      # B and C differ
        ssd(x, dt, A, B, C[..., :8])
    SK.ssd.launches = 0
    with pytest.raises(ValueError):                      # the kernel: CUDA only
        SK.ssd(x, dt, A, B, C)
    assert SK.ssd.launches == 0


@pytest.mark.parametrize("bad", ["heads", "dtype", "device"])
def test_ssd_refuses_an_initial_state_of_another_shape_or_type(bad):
    x, dt, A, B, C = _torch(_inputs(1, 64, 4, 32, 2, 16))
    init = {"heads": torch.zeros(1, 2, 32, 16),
            "dtype": torch.zeros(1, 4, 32, 16, dtype=torch.float64),
            "device": torch.zeros(1, 4, 32, 16, device="meta")}[bad]
    with pytest.raises(ValueError, match="initial_state"):
        ssd(x, dt, A, B, C, initial_state=init)


# ---------------------------------------------------------------------------
# The Mamba2 layer and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_arch("mamba2-2.7b", smoke=True).replace(dtype="float32")
    tcfg = get_arch("mamba2-2.7b", smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_apply_mamba2_prefill_and_decode_match_jax(model):
    jcfg, tcfg, _, _ = model
    jp = JSSM.init_mamba2(jax.random.key(1), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(2).randn(2, 64, jcfg.d_model) \
        .astype(np.float32)
    jc = JSSM.init_mamba2_cache(jcfg, 2, jnp.float32)
    tc = TSSM.init_mamba2_cache(tcfg, 2, torch.float32)
    want, jc = JSSM.apply_mamba2(jp, jcfg, jnp.asarray(x), cache=jc)
    got, tc = TSSM.apply_mamba2(tp, tcfg, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for step in range(4):
        xs = np.random.RandomState(10 + step).randn(2, 1, jcfg.d_model) \
            .astype(np.float32)
        want, jc = JSSM.apply_mamba2(jp, jcfg, jnp.asarray(xs), cache=jc)
        got, tc = TSSM.apply_mamba2(tp, tcfg, torch.from_numpy(xs), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    for key in ("conv", "state"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, rtol=1e-5)
    # scoring without a cache, as the JAX model's forward calls it
    want, _ = JSSM.apply_mamba2(jp, jcfg, jnp.asarray(x))
    got, none = TSSM.apply_mamba2(tp, tcfg, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _mamba2_layer(jcfg, seed=1):
    jp = JSSM.init_mamba2(jax.random.key(seed), jcfg, jnp.float32)
    # A_log, dt_bias and D away from their init values, so decay, step and
    # skip all vary by head
    rng = np.random.RandomState(seed)
    jp = dict(jp, A_log=jnp.asarray(rng.randn(*jp["A_log"].shape) * 0.5,
                                    jnp.float32),
              dt_bias=jnp.asarray(rng.randn(*jp["dt_bias"].shape) * 0.5,
                                  jnp.float32))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("S", [2, 40, 64])
def test_apply_mamba2_continues_from_a_cached_state_like_jax(model, S):
    """A multi-token call (S <= chunk, which JAX's chunked scan takes) on a
    cache that holds a non-zero SSM state and conv carry: output and both
    cache parts equal JAX's to 1e-5 (float32, sums in another order)."""
    jcfg, tcfg, _, _ = model
    jp, tp = _mamba2_layer(jcfg)
    rng = np.random.RandomState(S)
    jc = JSSM.init_mamba2_cache(jcfg, 2, jnp.float32)
    conv = (rng.randn(*jc["conv"].shape) * 0.5).astype(np.float32)
    state = (rng.randn(*jc["state"].shape) * 0.5).astype(np.float32)
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    want, jc = JSSM.apply_mamba2(jp, jcfg, jnp.asarray(x),
                                 cache={"conv": jnp.asarray(conv),
                                        "state": jnp.asarray(state)})
    tc = {"conv": torch.from_numpy(conv.copy()),
          "state": torch.from_numpy(state.copy())}
    got, tc = TSSM.apply_mamba2(tp, tcfg, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for key in ("conv", "state"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("split", [1, 24, 40])
def test_prompt_in_two_pieces_equals_the_whole_prompt(model, split):
    """The layer fed x[:, :split] then x[:, split:] through one cache ends
    where x fed at once does (outputs and cache to 1e-5: the chunks fall
    elsewhere), and each piece equals JAX's call on the same cache."""
    jcfg, tcfg, _, _ = model
    jp, tp = _mamba2_layer(jcfg, seed=2)
    x = np.random.RandomState(split).randn(2, 64, jcfg.d_model) \
        .astype(np.float32)
    whole, wc = TSSM.apply_mamba2(
        tp, tcfg, torch.from_numpy(x),
        cache=TSSM.init_mamba2_cache(tcfg, 2, torch.float32))
    tc = TSSM.init_mamba2_cache(tcfg, 2, torch.float32)
    jc = JSSM.init_mamba2_cache(jcfg, 2, jnp.float32)
    outs = []
    for piece in (x[:, :split], x[:, split:]):
        want, jc = JSSM.apply_mamba2(jp, jcfg, jnp.asarray(piece), cache=jc)
        got, tc = TSSM.apply_mamba2(tp, tcfg, torch.from_numpy(piece),
                                    cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        outs.append(got)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, atol=1e-5,
                               rtol=1e-5)
    for key in ("conv", "state"):
        torch.testing.assert_close(tc[key], wc[key], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, rtol=1e-5)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 128)
    want, _ = JTF.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TTF.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert got.shape == (2, 128, TTF.padded_vocab(tcfg)) and float(aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_prefill_and_decode_match_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 64, seed=1)
    jc = JTF.init_cache(jcfg, 2, 96)
    tc = TTF.init_cache(tcfg, 2, 96, device="cpu")
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
    assert tc["pos"].tolist() == [76, 76] and int(jc["pos"]) == 76


def test_greedy_decode_tokens_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens(jcfg, 1, 64, seed=2)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(prompt), 10, 96))
    got, margins = TS.greedy_decode(tp, tcfg, torch.from_numpy(prompt).long(),
                                    10, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    assert margins.shape == (1, 10) and bool((margins >= 0).all())


@pytest.mark.parametrize("S", [100, 130])
def test_ragged_prefill_matches_jax_token_by_token(model, S):
    """A prompt of S tokens, not a multiple of the chunk (64), which the
    JAX model's chunked scan refuses: its logits at every position equal
    JAX's prompt fed one token at a time through ``decode_step``."""
    jcfg, tcfg, jp, tp = model
    prompt = _tokens(jcfg, 1, S, seed=S)
    tc = TTF.init_cache(tcfg, 1, S, device="cpu")
    got, tc = TTF.prefill(tp, tcfg, torch.from_numpy(prompt).long(), tc)
    jc = JTF.init_cache(jcfg, 1, S)
    step = jax.jit(lambda p, t, c: JTF.decode_step(p, jcfg, t, c))
    want = []
    for t in range(S):
        logits, jc = step(jp, jnp.asarray(prompt[:, t:t + 1]), jc)
        want.append(np.asarray(logits))
    np.testing.assert_allclose(got.numpy(), np.concatenate(want, axis=1),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        tc["layers"][-1]["state"].numpy(),
        np.asarray(jc["blocks"]["sub0"]["state"][-1]), atol=1e-4, rtol=1e-4)


def test_one_token_and_reused_rows_start_from_zero_state(model):
    """A one-token prompt (the recurrent branch) and a multi-token prompt,
    each prefilled into a row another request used: both equal a fresh
    cache's result, and the row's neighbours are untouched."""
    _, tcfg, _, tp = model
    stacked = TTF.init_cache(tcfg, 2, 64, device="cpu")
    first = torch.from_numpy(_tokens(tcfg, 1, 40, seed=5)).long()
    TTF.prefill(tp, tcfg, first, TTF.cache_rows(stacked, 1, 2))
    TTF.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.long), stacked)
    for S in (1, 30):
        prompt = torch.from_numpy(_tokens(tcfg, 1, S, seed=6 + S)).long()
        row0 = [{k: v[0].clone() for k, v in c.items()}
                for c in stacked["layers"]]
        got, _ = TTF.prefill(tp, tcfg, prompt, TTF.cache_rows(stacked, 1, 2))
        assert all(torch.equal(c[k][0], r[k]) for c, r in
                   zip(stacked["layers"], row0) for k in r)
        want, fresh = TTF.prefill(tp, tcfg, prompt,
                                  TTF.init_cache(tcfg, 1, 64, device="cpu"))
        assert torch.equal(got, want), S
        for c, f in zip(stacked["layers"], fresh["layers"]):
            assert torch.equal(c["state"][1:2], f["state"])
            assert torch.equal(c["conv"][1:2], f["conv"])
        step = torch.full((2, 1), 3, dtype=torch.long)
        a, _ = TTF.decode_step(tp, tcfg, step, stacked)
        b, _ = TTF.decode_step(tp, tcfg, step[:1], fresh)
        torch.testing.assert_close(a[1:2], b, atol=1e-6, rtol=1e-6)
        assert stacked["pos"].tolist()[1] == S + 1


def test_prefill_scans_from_no_state_and_a_cached_call_from_the_cache(
        model, monkeypatch):
    """``prefill`` zeroes the row and scans without an initial state (the
    kernel's path without a state term); a later multi-token call on the
    same cache hands the scan the cached state."""
    _, tcfg, _, tp = model
    seen = []

    def spy(*args, initial_state=None, **kw):
        seen.append(None if initial_state is None else initial_state.clone())
        return ssd(*args, initial_state=initial_state, **kw)

    monkeypatch.setattr(TSSM, "ssd", spy)
    cache = TTF.init_cache(tcfg, 1, 64, device="cpu")
    prompt = torch.from_numpy(_tokens(tcfg, 1, 30, seed=9)).long()
    TTF.prefill(tp, tcfg, prompt, cache)
    n_mamba = tcfg.layer_kinds().count("M")
    assert len(seen) == n_mamba and all(s is None for s in seen)
    layer = tp["layers"][0]["mamba"]
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 5, tcfg.d_model)
                         .astype(np.float32))
    state = cache["layers"][0]["state"].clone()
    TSSM.apply_mamba2(layer, tcfg, x, cache=cache["layers"][0])
    assert torch.equal(seen[-1], state) and bool(state.abs().max() > 0)


def test_init_params_layout_matches_jax():
    jcfg = jax_get_arch("mamba2-2.7b", smoke=True)
    tcfg = get_arch("mamba2-2.7b", smoke=True)
    shapes = JTF.init_params_shape(jcfg)
    jp = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    want = transformer_params_from_jax(jp, tcfg, "cpu")
    got = TTF.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(got) == _shapes(want)
    jm = shapes["blocks"]["sub0"]["mamba"]
    tm = got["layers"][0]["mamba"]
    assert sorted(tm) == sorted(jm) == sorted(
        ["w_in", "conv_w", "A_log", "D", "dt_bias", "ssm_norm", "w_out_ssm"])
    for k in tm:
        assert str(tm[k].dtype).split(".")[-1] == str(jm[k].dtype), k
    cache = TTF.init_cache(tcfg, 3, 16, device="cpu")
    jcache = JTF.init_cache(jcfg, 3, 16)
    for key in ("conv", "state"):
        assert tuple(cache["layers"][0][key].shape) == \
            jcache["blocks"]["sub0"][key].shape[1:]
        assert str(cache["layers"][0][key].dtype).split(".")[-1] == \
            str(jcache["blocks"]["sub0"][key].dtype)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items()
                      for x in _shapes(v, f"{prefix}/{k}"))
    if isinstance(tree, list):
        return sorted(x for i, v in enumerate(tree)
                      for x in _shapes(v, f"{prefix}/{i}"))
    return [(prefix, tuple(tree.shape))]


def test_full_config_equals_jax():
    want, got = jax_get_arch("mamba2-2.7b"), get_arch("mamba2-2.7b")
    assert got.__dict__.keys() == want.__dict__.keys()
    for k in got.__dict__:
        a, b = getattr(got, k), getattr(want, k)
        assert (a.__dict__ if hasattr(a, "__dict__") else a) == \
            (b.__dict__ if hasattr(b, "__dict__") else b), k
