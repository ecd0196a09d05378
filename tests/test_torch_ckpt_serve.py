"""Serving from a checkpoint, across the packages, and the launchers'
``--trace`` / ``--profile`` / ``--profile-dir`` / ``--ckpt`` flags.

* ``transformer.init_params_shape`` gives ``init_params``'s tree (paths,
  shapes, types) as meta tensors for every ported arch, at SMOKE against
  ``init_params`` and at full width, in the training layout, against the
  JAX package's ``init_params_shape``.
* A checkpoint that the port's ``launch.train --ckpt-out`` writes
  (mamba2-2.7b SMOKE, bf16) is restored by the JAX package's
  ``ServeEngine.from_checkpoint`` and by the port's, leaf for leaf equal;
  a JAX-written one likewise. Both engines serve the same requests
  (prompts within one 64-token chunk, which the JAX model's scan needs)
  with the same greedy tokens.
* ``launch.train.main`` with ``--trace --profile --profile-dir
  --ckpt-out`` on the CPU, its depth cut by ``--layers``: the Chrome trace
  parses and holds the ``train_step`` spans, its ``.jsonl`` round-trips
  through ``read_jsonl``, the torch.profiler trace is written under
  ``--profile-dir``; ``launch.serve.main(["--ckpt", ...])`` serves the
  cut model, rebuilt from the checkpoint's meta, with ``--trace`` and
  ``--profile``.
"""
import json
import os

import jax
import numpy as np
import pytest

from jax_replay import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.launch import train as JT
from repro.models import transformer as JTF
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import generate_requests as j_generate
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as TSRV
from repro_torch.launch import train as TT
from repro_torch.models import transformer as TTF
from repro_torch.obs import read_jsonl
from repro_torch.serve import (SchedulerConfig, ServeEngine, TrafficConfig,
                               generate_requests)
from repro_torch.utils.tree import tree_flatten_with_path

SCHED = dict(n_slots=3, max_seq_len=96, max_queue=32)
TRAFFIC = dict(process="poisson", rate_rps=2e5, n_requests=6,
               mean_prompt_len=16, max_prompt_len=64, mean_out_len=5,
               max_out_len=8, seed=3)


def _leaves(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in
            tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_shape_is_init_params_tree(arch):
    cfg = get_arch(arch, smoke=True)
    shape = TTF.init_params_shape(cfg)
    assert all(t.is_meta for _, t in tree_flatten_with_path(shape)[0])
    assert _leaves(shape) == _leaves(TTF.init_params(cfg, seed=0,
                                                     device="cpu"))
    # at full width, in the training layout, the reference's template
    full = TTF.to_grouped(TTF.init_params_shape(get_arch(arch)),
                          get_arch(arch))
    want = JTF.init_params_shape(jax_get_arch(arch))
    assert [(p, s, str(d).removeprefix("torch.")) for p, s, d in
            _leaves(full)] == [
        (jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
        for p, a in jax.tree_util.tree_flatten_with_path(want)[0]]


def _port_checkpoint(directory):
    TT.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
             "--clients", "2", "--seq", "64", "--steps", "4", "--T1", "2",
             "--k1", "1", "--stages", "2", "--ckpt-out", directory])


def _jax_checkpoint(directory):
    JT.main(["--arch", "mamba2-2.7b", "--smoke", "--clients", "2",
             "--seq", "64", "--steps", "2", "--T1", "2", "--k1", "1",
             "--stages", "1", "--ckpt-out", directory])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_serves_the_same_tokens_in_both_packages(tmp_path,
                                                            writer):
    d = str(tmp_path / "ck")
    (_port_checkpoint if writer == "port" else _jax_checkpoint)(d)
    jeng = JServeEngine.from_checkpoint(
        d, scheduler=JSchedulerConfig(**SCHED))
    teng = ServeEngine.from_checkpoint(d, torch_device="cpu",
                                       scheduler=SchedulerConfig(**SCHED))
    assert teng.cfg.name == jeng.cfg.name == "mamba2-2.7b-smoke"
    # the restored params: the checkpoint's leaves in both packages
    got = tree_flatten_with_path(TTF.to_grouped(teng.params, teng.cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jeng.params)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), path)
    jrep = jeng.run(j_generate(JTrafficConfig(**TRAFFIC),
                               jeng.cfg.vocab_size))
    trep = teng.run(generate_requests(TrafficConfig(**TRAFFIC),
                                      teng.cfg.vocab_size))
    assert len(trep.completed) == len(jrep.completed) == 6
    assert [r.tokens for r in trep.records] == \
        [r.tokens for r in jrep.records]


def test_train_and_serve_launchers_trace_profile_and_checkpoint(tmp_path):
    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    trace = str(tmp_path / "train.json")
    ds = TT.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                  "--layers", "1",
                  "--clients", "2", "--seq", "64", "--steps", "6",
                  "--T1", "2", "--k1", "1", "--stages", "2",
                  "--trace", trace, "--profile", "--profile-dir", prof,
                  "--profile-calls", "2", "--ckpt-out", ck])
    assert ds.iters_total == 6
    events = json.load(open(trace))["traceEvents"]
    steps = [e for e in events if e.get("name") == "profile.train_step"]
    assert len(steps) == 6 and all(e["ph"] == "X" for e in steps)
    assert any(e.get("name") == "stage" for e in events)
    spans = read_jsonl(trace + "l")
    assert len(spans) == len([e for e in events if e["ph"] == "X"])
    assert sum(s.name == "profile.sync_step" for s in spans) == \
        ds.rounds_total
    rows = {r["name"]: r for r in ds.profile.skew_table()}
    assert rows["train_step"]["calls"] == 6 and rows["train_step"][
        "modeled_s"] > 0
    traced = [r for r in ds.profile.records if r.attrs.get("traced")]
    assert len(traced) == 2
    assert os.listdir(prof) == [os.path.basename(ds.profile.trace_path)]
    assert json.load(open(ds.profile.trace_path))["traceEvents"]

    assert ServeEngine.from_checkpoint(
        ck, torch_device="cpu").cfg.n_layers == 1
    serve_trace = str(tmp_path / "serve.json")
    report = TSRV.main(["--ckpt", ck, "--device", "cpu", "--requests", "4",
                        "--slots", "2", "--trace", serve_trace,
                        "--profile"])
    assert len(report.completed) == 4
    rows = {r["name"]: r for r in report.profile.skew_table()}
    assert rows["serve.prefill"]["calls"] == report.n_prefills == 4
    assert rows["serve.decode_step"]["calls"] == report.n_steps
    names = {e.get("name") for e in json.load(open(serve_trace))[
        "traceEvents"]}
    assert {"serve_run", "decode_step", "profile.serve.prefill"} <= names
    assert read_jsonl(serve_trace + "l")


def test_serve_launcher_needs_a_checkpoint_or_an_arch(tmp_path):
    with pytest.raises(SystemExit):
        TSRV.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        TSRV.main(["--ckpt", str(tmp_path), "--arch", "mamba2-2.7b"])
    with pytest.raises(FileNotFoundError):
        TSRV.main(["--ckpt", str(tmp_path / "none"), "--device", "cpu"])
