"""The port's profiler ranges and the wall clock its spans share with the
profiler, on the CPU.

* A SMOKE mamba2 step and a SMOKE musicgen step through
  ``build_train_steps`` and ``StagewiseDriver`` under
  ``torch.profiler``: each range opens as often as the step runs its
  layer, nested as the step nests them (``ssd.forward`` inside
  ``local_sgd.forward``, and for the remat recompute inside
  ``local_sgd.backward``).
* With no profiler, ``layer()`` and ``NullTracer.span`` return the shared
  no-op.
* A ``Tracer`` wall span and the range it mirrors agree on both ends.
* The driver's ``reduce`` span takes the round's device time once a later
  loss read has synchronised, and only under a ``Tracer``; that measured
  time stays out of the span tree's fingerprint.
* The serve engine's run span closes when a call inside it raises.
"""
import pytest
import torch
from range_cases import (MIXER, expected_counts, host_ranges, inside,
                         smoke_run)
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import stl_sgd
from repro_torch.obs import trace as T


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", sorted(MIXER))
def test_each_range_opens_once_a_layer_call(arch):
    want = expected_counts(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        smoke_run(arch, "cpu")
    got = host_ranges(prof, set(want))
    counts = {n: sum(1 for g in got if g[0] == n) for n in want}
    assert counts == want


@pytest.mark.parametrize("arch", sorted(MIXER))
def test_ranges_nest_as_the_step_runs_them(arch):
    mixer = MIXER[arch]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        smoke_run(arch, "cpu")
    got = host_ranges(prof, set(expected_counts(arch)))

    def named(n):
        return [g for g in got if g[0] == n]

    fwd, bwd = named("local_sgd.forward"), named("local_sgd.backward")
    mixed = named(f"{mixer}.forward")
    # the forward's call, then the remat recompute's in the backward
    assert sum(inside(m, fwd) for m in mixed) == len(mixed) // 2
    assert sum(inside(m, bwd) for m in mixed) == len(mixed) // 2
    assert all(inside(m, bwd) for m in named(f"{mixer}.backward"))
    burst = named("driver.local_steps")
    for n in ("local_sgd.forward", "local_sgd.backward", "local_sgd.update",
              "driver.batch", "driver.loss_read"):
        assert all(inside(g, burst) for g in named(n)), n
    assert not any(inside(g, burst) for g in named("driver.reduce"))
    assert all(inside(g, named("engine.stage"))
               for g in named("driver.reduce") + burst)


def test_without_a_profiler_ranges_are_the_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    assert T.layer("local_sgd.forward") is T._NOOP_SPAN
    assert T.NULL_TRACER.span("reduce", cat=T.CAT_COMM,
                              track="driver") is T._NOOP_SPAN
    assert not T.NULL_TRACER and T.NULL_TRACER.spans == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(T.layer("x"), T._Range)
        assert isinstance(T.NULL_TRACER.span("reduce", track="driver"),
                          T._Range)
    assert T.layer("x") is T._NOOP_SPAN


def test_ranges_are_ops_that_kernels_link_to():
    """Not user annotations: the profiler links a kernel to the innermost
    open op that is not one, so a kernel launched outside any aten op (a
    ``ctypes`` launch) links to the range around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.layer("local_sgd.update"):
            with T.NULL_TRACER.span("reduce", track="driver"):
                pass
    got = {e.name(): e.is_user_annotation()
           for e in prof.profiler.kineto_results.events()}
    assert got == {"local_sgd.update": False, "driver.reduce": False}


def test_an_untraced_driver_run_opens_no_range(monkeypatch):
    made = []
    monkeypatch.setattr(T, "_Range", lambda name: made.append(name))
    ds = smoke_run("mamba2-2.7b", "cpu")
    assert ds.iters_total == 2 and made == []


def test_wall_spans_share_the_profilers_clock():
    tr = T.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("local_steps", track="driver"):
            with tr.span("reduce", track="driver"):
                torch.ones(64).sum()
    got = host_ranges(prof, {"driver.local_steps", "driver.reduce"})
    assert sorted(g[0] for g in got) == ["driver.local_steps",
                                         "driver.reduce"]
    for name, a, b in got:
        sp, = tr.find(name.split(".", 1)[1])
        assert sp.clock == T.WALL
        assert abs(sp.t0 - a / 1e9) < 1e-3 and abs(sp.t1 - b / 1e9) < 1e-3
    assert abs(T.wall_now() - tr.spans[0].t1) < 60.0


def test_profile_session_stamps_on_the_wall_clock():
    from repro_torch.obs import ProfileSession

    prof = ProfileSession()
    t = T.wall_now()
    with prof:
        prof.step("f", 1.0, lambda: None)
    r, = prof.records
    assert t <= r.t0 <= r.t1 <= T.wall_now()


class _Event:
    """A CUDA event pair's stand-in: the device time it reads."""

    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append("record")

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, end):
        self.log.append("elapsed")
        return 7.5


def test_reduce_span_gets_its_device_time_after_a_later_sync(monkeypatch):
    """Rounds are timed only under a Tracer; a round's span takes its time
    at the next loss read, the last round's when the run finishes, after
    waiting on its end event."""
    log, asked = [], []

    def events(self, tracer):
        asked.append(bool(tracer))
        return (_Event(log), _Event(log)) if tracer else None

    monkeypatch.setattr(stl_sgd.DriverBackend, "_round_events", events)
    tr = T.Tracer()
    smoke_run("mamba2-2.7b", "cpu", tracer=tr, k=1)
    rounds = tr.find("reduce", clock=T.WALL)
    assert [r.attrs["device_ms"] for r in rounds] == [7.5, 7.5]
    assert log == ["record", "record", "elapsed",
                   "record", "record", "synchronize", "elapsed"]
    smoke_run("mamba2-2.7b", "cpu", k=1)
    assert asked == [True, True, False, False] and len(log) == 7


@pytest.mark.parametrize("clock,same", [(T.WALL, True), (T.VIRTUAL, False)])
def test_fingerprint_leaves_out_a_wall_spans_measured_attrs(clock, same):
    """``device_ms``, ``measured_s`` and ``skew`` on a wall span are
    measured, so two runs' fingerprints agree whatever they read; on the
    deterministic clocks every attr counts, and on any clock an attr that
    is not measured."""
    def keys(ms, s=1):
        tr = T.Tracer()
        tr.add("reduce", 0.0, 1.0, clock=clock, track="driver",
               attrs={"s": s, "device_ms": ms, "measured_s": ms / 1e3,
                      "skew": ms})
        return tr.tree_keys()

    assert (keys(7.5) == keys(8.5)) is same
    assert keys(7.5, s=1) != keys(7.5, s=2)


def test_traced_driver_runs_share_a_fingerprint(monkeypatch):
    """Two traced runs whose rounds read different device times: the
    spans carry them, the fingerprints agree."""
    times = iter([7.5, 7.5, 8.5, 8.5])

    class Timed(_Event):
        def elapsed_time(self, end):
            return next(times)

    monkeypatch.setattr(stl_sgd.DriverBackend, "_round_events",
                        lambda self, tracer: (Timed([]), Timed([])))
    runs = []
    for _ in range(2):
        tr = T.Tracer()
        smoke_run("mamba2-2.7b", "cpu", tracer=tr, k=1)
        runs.append(tr)
    read = [[r.attrs["device_ms"] for r in tr.find("reduce", clock=T.WALL)]
            for tr in runs]
    assert read == [[7.5, 7.5], [8.5, 8.5]]
    assert runs[0].tree_keys() == runs[1].tree_keys()


@pytest.mark.parametrize("traced", [True, False])
def test_serve_run_span_closes_when_the_run_raises(traced):
    """An exception inside ``ServeEngine.run`` closes its ``serve_run``
    span and range; the range opens under a profiler with or without a
    Tracer."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF
    from repro_torch.serve import SchedulerConfig, ServeEngine
    from repro_torch.serve.traffic import Request

    cfg = get_arch("gemma2-27b", smoke=True).replace(dtype="float32")
    eng = ServeEngine(cfg, TF.init_params(cfg, seed=0, device="cpu"),
                      scheduler=SchedulerConfig(n_slots=1, max_seq_len=16,
                                                max_queue=1))

    def fail(*a):
        raise RuntimeError("prefill failed")

    eng._prefill = fail
    tr = T.Tracer() if traced else None
    req = Request(id=0, arrival_s=0.0, prompt=np.ones(4, np.int32), n_out=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="prefill failed"):
            eng.run([req], tracer=tr)
    got = host_ranges(prof, {"server.serve_run"})
    assert len(got) == 1 and got[0][2] > got[0][1]
    if traced:
        run, = tr.find("serve_run")
        assert tr._stack == [] and run.t1 > run.t0
