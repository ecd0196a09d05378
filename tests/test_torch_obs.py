"""The port's ``obs`` export, diff, SLO and profile modules, its package
APIs and ``tools/torch_bench_diff.py``, against the JAX package's.

* ``span_record`` / ``write_jsonl`` / ``to_chrome_trace`` /
  ``write_chrome_trace`` of the same spans (and series) give the
  reference's output: equal JSONL lines and equal trace events (only
  ``otherData.producer`` names the package); ``read_jsonl`` round-trips.
* ``validate_bench`` / ``diff_benches`` / ``diff_dirs`` give the same
  deltas, skips and errors; ``SLOMonitor`` the same breaches, evaluations
  and summaries (the reference's cases in ``tests/test_obs.py`` and
  ``tests/test_telemetry.py``, run through both packages).
* ``ProfileSession``: the skew rows of a toy driver reconcile, ``wrap``
  keeps the ``build_sync_step`` tags reachable, a session without a
  logdir is harmless, one with a logdir writes a Chrome trace (the whole
  session, or a window of ``trace_calls`` after a warm-up call), and a
  profiler that cannot start degrades to wall timing with a warning.
* ``tools/torch_bench_diff.py`` exits 0 / 1 / 2 as ``tools/bench_diff.py``.
* ``repro_torch.obs`` and ``repro_torch.utils`` export the reference's
  names; the tree helpers compute the reference's values.
"""
import io
import itertools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as J
import repro.utils as JU
import repro_torch.obs as T
import repro_torch.utils as TU
from repro_torch.obs import profile as TP
from repro_torch.configs.base import TrainConfig
from repro_torch.core.local_sgd import build_sync_step, sync_step_tags
from repro_torch.core.stl_sgd import StagewiseDriver, driver_state
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _toy_tracer(obs):
    """The reference test's toy spans (``tests/test_obs.py``), built with
    ``obs``'s Tracer."""
    tr = obs.Tracer(run_id="toy")
    rid = tr.begin("round", 0.0, clock=obs.VIRTUAL, track="server",
                   attrs={"k": 2})
    tr.add("local_steps", 0.0, 2e-3, cat="compute", clock=obs.VIRTUAL,
           track="client/0", attrs={"steps": 2})
    tr.end(rid, 3e-3)
    tr.add("reduce", 0.0, 1e-3, clock=obs.MODELED, track="hop/uplink",
           attrs={"bytes": 128})
    tr.add("reduce_leaf", 0.0, 4e-4, cat="comm", clock=obs.MODELED,
           track="leaf/1", attrs={"leaf": "['w']", "bytes": 64})
    tr.add("merge", 1e-3, 1.5e-3, cat="merge", clock=obs.VIRTUAL,
           track="server", attrs={"weight": 0.5})
    tr.add("stage", 100.0, 100.25, cat="control", track="engine",
           attrs={"s": 1})
    return tr


def _toy_series(obs):
    reg = obs.SeriesRegistry()
    q = reg.series("serve.queue_depth", obs.VIRTUAL, unit="requests")
    w = reg.series("host.step_s", obs.WALL, unit="s")
    for i in range(5):
        q.record(1e-3 * i, float(i % 3))
        w.record(100.0 + 0.1 * i, 0.01 * i)
    return reg


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def test_chrome_trace_equals_jax(tmp_path):
    want = J.to_chrome_trace(_toy_tracer(J), series=_toy_series(J))
    got = T.to_chrome_trace(_toy_tracer(T), series=_toy_series(T))
    assert got["traceEvents"] == want["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    assert got["otherData"] == dict(want["otherData"],
                                    producer="repro_torch.obs")
    pj = J.write_chrome_trace(_toy_tracer(J), str(tmp_path / "j.json"))
    pt = T.write_chrome_trace(_toy_tracer(T), str(tmp_path / "t.json"))
    assert json.load(open(pt))["traceEvents"] == \
        json.load(open(pj))["traceEvents"]


def test_jsonl_equals_jax_and_round_trips(tmp_path):
    pj = J.write_jsonl(_toy_tracer(J), str(tmp_path / "j.jsonl"))
    tr = _toy_tracer(T)
    pt = T.write_jsonl(tr, str(tmp_path / "t.jsonl"))
    assert open(pt).read() == open(pj).read()
    assert [T.span_record(s) for s in tr.spans] == \
        [J.span_record(s) for s in _toy_tracer(J).spans]
    back = T.read_jsonl(pt)
    assert [s.key() for s in back] == [s.key() for s in tr.spans]
    assert T.to_chrome_trace(back)["traceEvents"] == \
        T.to_chrome_trace(tr)["traceEvents"]


# ---------------------------------------------------------------------------
# BENCH diffing
# ---------------------------------------------------------------------------

def _bench(rows, name="toy", scale="smoke"):
    return {"bench": name, "schema": 1, "meta": {"scale": scale},
            "rows": rows}


BAD_BENCHES = [{"schema": 1, "rows": []},
               {"bench": "x", "schema": 2, "rows": []},
               {"bench": "x", "schema": 1, "rows": "nope"},
               {"bench": "x", "schema": 1, "rows": [3]},
               {"bench": "x", "schema": 1, "rows": [], "meta": 4},
               [1, 2]]


@pytest.mark.parametrize("rec", BAD_BENCHES)
def test_validate_bench_errors_equal_jax(rec):
    with pytest.raises(J.BenchSchemaError) as want:
        J.validate_bench(json.loads(json.dumps(rec)))
    with pytest.raises(T.BenchSchemaError) as got:
        T.validate_bench(json.loads(json.dumps(rec)))
    assert str(got.value) == str(want.value)


def test_diff_benches_equals_jax():
    base = _bench([{"algo": "stl_sc", "reducer": "dense",
                    "comm_time_s": 1.0, "rounds": 10, "p95_s": 0.2},
                   {"algo": "local", "reducer": "int8", "comm_bytes": 400},
                   {"algo": "gone", "rounds": 3}])
    cur = _bench([{"algo": "stl_sc", "reducer": "dense",
                   "comm_time_s": 1.10, "rounds": 8, "p95_s": "0.2"},
                  {"algo": "local", "reducer": "int8", "comm_bytes": 0},
                  {"algo": "new", "rounds": 1}])
    want = J.diff_benches(base, cur)
    got = T.diff_benches(base, cur)
    assert [(d.bench, d.cell, d.key, d.baseline, d.current) for d in got] \
        == [(d.bench, d.cell, d.key, d.baseline, d.current) for d in want]
    for a, b in zip(got, want):
        assert (a.ratio, a.regressed(0.05), a.improved(0.05), a.render()) \
            == (b.ratio, b.regressed(0.05), b.improved(0.05), b.render())
    assert T.DIFF_KEYS == J.DIFF_KEYS
    assert T.row_key(cur["rows"][0]) == J.row_key(cur["rows"][0])


def _write_dir(d, benches):
    d.mkdir(parents=True, exist_ok=True)
    for name, rec in benches.items():
        (d / f"BENCH_{name}.json").write_text(json.dumps(rec))


def test_diff_dirs_equals_jax(tmp_path):
    row = {"algo": "a", "comm_bytes": 100, "rounds": 4}
    _write_dir(tmp_path / "base", {
        "same": _bench([row]), "scaled": _bench([row], scale="full"),
        "only_base": _bench([row])})
    _write_dir(tmp_path / "cur", {
        "same": _bench([dict(row, rounds=5)]),
        "scaled": _bench([row], scale="smoke"),
        "only_cur": _bench([row])})
    args = (str(tmp_path / "base"), str(tmp_path / "cur"))
    want, got = J.diff_dirs(*args), T.diff_dirs(*args)
    assert got.compared == want.compared == ["BENCH_same.json"]
    assert got.skipped == want.skipped and len(got.skipped) == 3
    assert [d.render() for d in got.deltas] == \
        [d.render() for d in want.deltas]
    assert [d.render() for d in got.regressions(0.05)] == \
        [d.render() for d in want.regressions(0.05)] != []


def _bench_diff_cli(tool, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           *argv], capture_output=True, text=True, env=env,
                          timeout=120)


def test_torch_bench_diff_exit_codes(tmp_path):
    base, cur = tmp_path / "base", tmp_path / "cur"
    row = {"algo": "stl_sc", "reducer": "dense", "comm_time_s": 1.0,
           "comm_bytes": 1000}
    _write_dir(base, {"toy": _bench([row])})
    _write_dir(cur, {"toy": _bench([row])})
    ok = _bench_diff_cli("torch_bench_diff.py", str(base), str(cur))
    assert ok.returncode == 0, ok.stderr
    assert "0 regression(s)" in ok.stdout
    # a 10% modeled-seconds regression fails the 5% gate, as the
    # reference's tool judges it
    _write_dir(cur, {"toy": _bench([dict(row, comm_time_s=1.10)])})
    for tool in ("torch_bench_diff.py", "bench_diff.py"):
        bad = _bench_diff_cli(tool, str(base), str(cur))
        assert bad.returncode == 1
        assert "REGRESSED" in bad.stdout and "comm_time_s" in bad.stdout
    assert _bench_diff_cli("torch_bench_diff.py", str(base), str(cur),
                           "--tol", "0.2").returncode == 0
    # schema violations and a missing baseline are usage errors
    (base / "BENCH_toy.json").write_text('{"rows": []}')
    err = _bench_diff_cli("torch_bench_diff.py", str(base), str(cur))
    assert err.returncode == 2 and "missing required key" in err.stderr
    assert _bench_diff_cli("torch_bench_diff.py", str(tmp_path / "nope"),
                           str(cur)).returncode == 2


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

def _slo_case(obs, case):
    reg = obs.SeriesRegistry()
    ttft = reg.series("serve.ttft_s", obs.VIRTUAL, unit="s")
    kw = dict(window_steps=4.0, min_count=1)
    if case == "breach and recovery":
        samples = ([(float(t), 1.0) for t in range(6)]
                   + [(float(t), 20.0) for t in range(10, 14)] + [(20.0, 1.0)])
    elif case == "saturated":
        samples = ([(float(t), 1.0) for t in range(4)]
                   + [(float(t), 50.0) for t in range(10, 14)])
    elif case == "clean, partial telemetry":
        samples, kw = [(float(t), 1.0) for t in range(8)], {"tok_s_floor": 1.0}
    else:                                   # a throughput floor from below
        samples = []
        tok = reg.series("serve.tokens_total", obs.VIRTUAL, unit="tokens")
        e2e = reg.series("serve.e2e_s", obs.VIRTUAL, unit="s")
        for i in range(8):
            tok.record(float(i), float(i))
            e2e.record(float(i), 5.0 + 30.0 * (i % 2))
        kw["tok_s_floor"] = 10.0
    for t, v in samples:
        ttft.record(t, v)
    mon = obs.SLOMonitor(obs.serve_slo_targets(1.0, **kw))
    mon.evaluate(reg)
    tr = obs.Tracer()
    mon.emit_spans(tr)
    return mon, [(s.name, s.t0, s.t1, s.attrs) for s in tr.spans]


@pytest.mark.parametrize("case", ["breach and recovery", "saturated",
                                  "clean, partial telemetry", "floor"])
def test_slo_monitor_equals_jax(case):
    want, want_spans = _slo_case(J, case)
    got, got_spans = _slo_case(T, case)
    assert [vars(b) for b in got.breaches] == \
        [vars(b) for b in want.breaches]
    assert got.evaluations == want.evaluations
    assert got.summary() == want.summary()
    assert got_spans == want_spans
    if case != "clean, partial telemetry":
        assert got.breaches


def test_slo_targets_equal_jax():
    for kw in ({}, {"tok_s_floor": 3.0, "ttft_steps": 4.0}):
        assert [vars(t) for t in T.serve_slo_targets(2e-3, **kw)] == \
            [vars(t) for t in J.serve_slo_targets(2e-3, **kw)]
    with pytest.raises(ValueError, match="unknown agg"):
        T.SLOTarget("bad", "serve.ttft_s", "p42", 1.0, 1.0)


# ---------------------------------------------------------------------------
# ProfileSession
# ---------------------------------------------------------------------------

def _toy_driver(profile):
    def train_fn(state, batch, eta):
        return dict(state, step=state["step"] + 1), {"loss": 0.5}

    tcfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=4, k1=2.0, n_stages=2)
    train_w = profile.wrap(train_fn, "train_step", 1e-3)
    sync_w = profile.wrap(lambda state: state, "sync_step",
                          lambda *a, **k: 2e-3)
    return StagewiseDriver(tcfg, train_w, sync_w)


def test_profile_skew_table_reconciles():
    prof = T.ProfileSession()
    driver = _toy_driver(prof)
    state = driver_state({"w": torch.ones(8)}, 4)
    with prof:
        ds = driver.run(state, itertools.repeat(None), max_iters=12)
    assert ds.iters_total == 12
    rows = {r["name"]: r for r in prof.skew_table()}
    assert set(rows) == {"train_step", "sync_step"}
    assert rows["train_step"]["calls"] == 12
    assert rows["train_step"]["modeled_s"] == pytest.approx(12e-3)
    assert rows["sync_step"]["modeled_s"] == pytest.approx(
        rows["sync_step"]["calls"] * 2e-3)
    for r in rows.values():
        assert r["measured_s"] >= 0.0
        assert r["skew"] == r["measured_s"] / r["modeled_s"]
    tr = T.Tracer()
    prof.emit_spans(tr)
    spans = tr.find("profile.train_step") + tr.find("profile.sync_step")
    assert len(spans) == len(prof.records)
    for sp in spans:
        assert sp.clock == T.WALL
        assert "modeled_s" in sp.attrs and "measured_s" in sp.attrs
        assert sp.key()[6:8] == (None, None)            # wall ts excluded
    assert math.fsum(sp.t1 - sp.t0 for sp in spans) \
        == math.fsum(r.measured_s for r in prof.records)
    table = T.format_skew_table(prof.skew_table())
    assert "train_step" in table and "skew" in table
    assert T.format_skew_table([]) == J.format_skew_table([])
    # the reference renders the same rows alike
    assert table == J.format_skew_table(prof.skew_table())


@pytest.mark.parametrize("reducer", ["dense", "int8"])
def test_profile_wrap_preserves_sync_step_tags(reducer):
    raw = build_sync_step(reducer)
    prof = T.ProfileSession()
    wrapped = prof.wrap(raw, "sync_step", 1e-3)
    assert wrapped.__wrapped__ is raw
    assert sync_step_tags(wrapped) == sync_step_tags(raw)
    assert sync_step_tags(wrapped)["reducer"] is not None


def test_profile_session_without_logdir_is_harmless():
    prof = T.ProfileSession()
    with prof:
        out = prof.step("f", 0.5, lambda a, b: a + b, 2, 3)
        t = prof.step("g", 0.5, lambda: {"x": torch.ones(3)})
    assert out == 5 and torch.equal(t["x"], torch.ones(3))
    assert prof.profiler is None and prof.trace_path is None
    assert [r.name for r in prof.records] == ["f", "g"]


def test_profile_session_with_logdir_writes_its_trace(tmp_path):
    prof = T.ProfileSession(logdir=str(tmp_path / "prof"))
    with prof:
        prof.step("matmul", 1e-3, lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert prof.trace_path and os.path.dirname(prof.trace_path) == \
        str(tmp_path / "prof")
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert not prof.records[0].attrs     # the whole session: no window


def test_profile_session_traces_a_window_of_calls(tmp_path):
    prof = T.ProfileSession(logdir=str(tmp_path), trace_calls=2)
    with prof:
        for i in range(5):
            prof.step(f"s{i}", 1e-3, lambda n=i + 1: torch.ones(n, 8) * 3)
    assert [bool(r.attrs.get("traced")) for r in prof.records] == \
        [False, True, True, False, False]
    assert prof.trace_path and os.path.exists(prof.trace_path)
    with pytest.raises(ValueError):
        T.ProfileSession(trace_calls=0)


def test_profile_session_degrades_when_the_profiler_cannot_start(
        tmp_path, monkeypatch):
    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    stream = io.StringIO()
    monkeypatch.setattr(TP.log, "stream", stream)
    prof = T.ProfileSession(logdir=str(tmp_path))
    with prof:
        assert prof.step("f", 1.0, lambda: 7) == 7
    assert prof.trace_path is None and len(prof.records) == 1
    assert "profiler_unavailable" in stream.getvalue()


# ---------------------------------------------------------------------------
# Package APIs
# ---------------------------------------------------------------------------

def test_obs_and_utils_export_the_reference_api():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert all(hasattr(T, n) for n in T.__all__)
    assert sorted(TU.__all__) == sorted(JU.__all__)
    assert all(hasattr(TU, n) for n in TU.__all__)


def test_tree_helpers_equal_jax():
    rng = np.random.RandomState(0)
    a = {"w": rng.randn(3, 4).astype(np.float32),
         "b": [rng.randn(3).astype(np.float32),
               rng.randn(3, 2).astype(np.float32)]}
    b = {"w": rng.randn(3, 4).astype(np.float32),
         "b": [rng.randn(3).astype(np.float32),
               rng.randn(3, 2).astype(np.float32)]}
    ja = {"w": jnp.asarray(a["w"]), "b": [jnp.asarray(x) for x in a["b"]]}
    jb = {"w": jnp.asarray(b["w"]), "b": [jnp.asarray(x) for x in b["b"]]}
    ta = {"w": torch.from_numpy(a["w"]),
          "b": [torch.from_numpy(x) for x in a["b"]]}
    tb = {"w": torch.from_numpy(b["w"]),
          "b": [torch.from_numpy(x) for x in b["b"]]}

    def same(t, j):
        got, want = tree_leaves(t), jax.tree.leaves(j)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)

    same(TU.tree_add(ta, tb), JU.tree_add(ja, jb))
    same(TU.tree_scale(ta, 0.5), JU.tree_scale(ja, 0.5))
    same(TU.tree_stack_leading([ta, tb]), JU.tree_stack_leading([ja, jb]))
    same(TU.tree_take(TU.tree_stack_leading([ta, tb]), 1), jb)
    assert float(TU.tree_l2_norm(ta)) == pytest.approx(
        float(JU.tree_l2_norm(ja)), rel=1e-6)
    assert TU.tree_size(ta) == JU.tree_size(ja) == 12 + 3 + 6
    assert TU.tree_bytes(ta) == JU.tree_bytes(ja) == 4 * 21
    bf = {"w": torch.zeros(5, dtype=torch.bfloat16)}
    assert TU.tree_bytes(bf) == JU.tree_bytes(
        {"w": jnp.zeros(5, jnp.bfloat16)}) == 10
