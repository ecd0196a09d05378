"""The port's LM-training example against the JAX package's driver.

``train_llm_stl``'s sections run on the CPU at qwen3-mini's width (the
script's default config) in float32, from the JAX package's initial state
(``utils/convert.train_state_from_jax``), over the same synthetic batches
(numpy draws), cut to 16 local steps: 4 clients on each package's 1×1
host mesh (gloo here), ``build_train_steps(..., momentum=0.9)`` and the
script's STL-SGD^sc schedule. Tolerances: the stages, iterations, rounds
and comm ledger equal; each stage's mean loss within 1e-5 relative
(float32 summation order), as ``tests/test_torch_train_driver.py``
states it. Why 16 steps: at η₁ 0.3 with momentum 0.9 the loss climbs
from 8.7 to ~25 over the first stage, and a rounding difference grows
about 10^5-fold between steps 16 and 24 — the port against itself on 1
and on 3 CPU threads ends step 24 at stage means of 22.73 and 25.23.
"""
import dataclasses

import jax
import pytest
import torch

from jax_replay import load_example, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import local_sgd as JLS
from repro.core.stl_sgd import StagewiseDriver as JDriver
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.launch.train import synthetic_batches as j_batches
from repro_torch.utils.convert import train_state_from_jax

tl = load_example("train_llm_stl")
CLIENTS, STEPS = 4, 16


def jax_config(cfg):
    """The port's config as the JAX package's (same fields)."""
    return jax_get_arch("qwen3-14b", smoke=True).replace(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_ff=cfg.d_ff, vocab_size=cfg.vocab_size, dtype=cfg.dtype,
        attention=JAttentionConfig(**dataclasses.asdict(cfg.attention)))


@pytest.mark.parametrize("hundred_m", [False])
def test_train_matches_jax(hundred_m):
    cfg, batch, seq = tl.model_config(hundred_m)
    cfg = cfg.replace(dtype="float32")
    jcfg = jax_config(cfg)
    jstate = JLS.init_state(jax.random.key(0), jcfg, CLIENTS)
    state = train_state_from_jax(to_numpy_tree(jstate), "cpu")
    step, sync, _ = JLS.build_train_steps(jcfg, j_host_mesh(1, 1),
                                          client_axis="data", momentum=0.9)
    want = JDriver(JTrainConfig(**tl.SCHEDULE), jax.jit(step),
                   jax.jit(sync)).run(
        jstate, j_batches(jcfg, CLIENTS, batch, seq, seed=0),
        max_iters=STEPS)
    got, dt = tl.train(cfg, state, batch, seq, STEPS,
                       device=torch.device("cpu"))
    assert dt > 0
    assert [(r.stage, r.k, r.iters, r.rounds) for r in got.results] == \
        [(r.stage, r.k, r.iters, r.rounds) for r in want.results]
    assert (got.iters_total, got.rounds_total) == (STEPS, STEPS // 4)
    for a, b in zip(got.results, want.results):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=1e-5)
    assert got.comm_bytes_total == want.comm_bytes_total
    assert not torch.distributed.is_initialized()


def test_model_configs_match_the_jax_script():
    """qwen3-mini and the ~100M config: the JAX script's fields."""
    mini, b, s = tl.model_config()
    assert (mini.n_layers, mini.d_model, mini.d_ff, mini.vocab_size, b, s) \
        == (4, 256, 768, 4096, 2, 128)
    big, b, s = tl.model_config(hundred_m=True)
    assert (big.n_layers, big.d_model, big.d_ff, big.vocab_size, b, s) == \
        (8, 512, 1536, 8192, 2, 256)
    assert (big.attention.n_heads, big.attention.n_kv_heads,
            big.attention.head_dim, big.attention.qk_norm) == (8, 4, 64, True)
