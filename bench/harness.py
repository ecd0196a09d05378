"""One run of one training cell.

Set-up builds the training state of ``core/local_sgd`` (the clients'
replicas stacked, plain-SGD moments) from weights the benchmark makes on
the device from the seed, and the steps of ``build_train_steps`` on a 1×1
``make_host_mesh``, as ``launch/train`` builds them; one
``core/stl_sgd.StagewiseDriver`` runs the configuration's schedule over
the benchmark's feed, from set-up through the window. Set-up is the
driver's first ``STEPS`` local steps and the round after them: they warm
up every shape the window uses, and the harness reads from them what the
check compares (each step's loss, the first gradient from the moments
after step 1, each client's change after step 3, the replicas after the
round). The window is the driver's next steps for ``seconds``; it closes
at the first step boundary after that, in ``torch.cuda.synchronize()``.

With ``trace`` a profiler records local steps ``PROFILE_FROM`` to
``PROFILE_TO`` - 1 and the round after them inside the window, every
round of the window is timed between two synchronisations, and the run
reports the per-layer metrics.

After the window the program's state is freed and the plain reference
(``bench/reference``) works out the same readings from the same weights
and batches; ``bench/check.py`` compares them.
"""
from __future__ import annotations

import functools
import gc
import math
import sys
import time
from typing import Callable, Dict, List

from bench import check, data, spec
from bench import trace as T
from bench.reference import train as R

STEPS = R.STEPS            # set-up's local steps: the first round follows
# the profiled stretch of a traced run: local steps PROFILE_FROM ..
# PROFILE_TO - 1 and the round after step 8 (k₁ = 4: rounds follow steps
# 4, 8, then every 8)
PROFILE_FROM, PROFILE_TO = STEPS + 3, STEPS + 5
RANGES = ("ssd.backward", "flash_attention.backward")


class WindowClosed(Exception):
    """Raised from the feed once the window has run its seconds."""


_T0 = time.monotonic()


def log(msg: str):
    print(f"{msg} [{time.monotonic() - _T0:.3f} s]", file=sys.stderr,
          flush=True)


def _walk(tree, path=""):
    """(dotted path, leaf) pairs of a dict/list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}.{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}.{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _put(tree, path: str, value):
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    if isinstance(tree, list):
        tree[int(keys[-1])] = value
    else:
        tree[keys[-1]] = value


def build_state(cfg, model: dict, clients: int, optimizer: str, seed: int,
                dev) -> dict:
    """The port's training state (``local_sgd.init_state``'s layout) with
    the benchmark's weights: every replica the same leaves, the moments
    plain SGD's zeros."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.optim import make_optimizer

    shapes = TF.to_grouped(TF.init_params_shape(cfg), cfg)
    specs = {lf.path: lf for lf in data.leaf_specs(model)}
    seen = set()
    for path, t in list(_walk(shapes)):
        lf = specs.get(path)
        if lf is None or tuple(t.shape) != lf.shape or t.dtype != lf.dtype:
            raise ValueError(f"the port's leaf {path} {tuple(t.shape)} "
                             f"{t.dtype} is not the benchmark's {lf}")
        x = data.make_leaf(lf, seed, dev)
        _put(shapes, path, x.unsqueeze(0).expand(
            (clients,) + tuple(x.shape)).contiguous())
        del x
        seen.add(path)
    if seen != set(specs):
        raise ValueError(f"benchmark leaves the port lacks: "
                         f"{sorted(set(specs) - seen)}")
    opt_init, _ = make_optimizer(optimizer)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"params": shapes, "opt": opt_init(shapes), "step": 0}


class Run:
    """The driver's callbacks: the steps wrapped to take the check's
    readings and the trace's spans, and the feed that opens and closes
    the window."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, dev, t_start: float, train_fn: Callable,
                 sync_fn: Callable):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.dev, self.t_start = trace, dev, t_start
        self.train_fn, self.sync_fn = train_fn, sync_fn
        self.specs = data.leaf_specs(cell.model)
        self.cdf = data.zipf_cdf(cell.model["vocab_size"],
                                 cell.traffic.get("zipf_exponent", 1.0), dev)
        self.readings = {"losses": [], "grad": [], "change": [],
                         "round": [], "grad_probe": []}
        self.steps = 0
        self.rounds = 0
        self.losses: List[float] = []      # every step's loss
        self.setup_s = None
        self.window = None                 # (t0, t1) once closed
        self.window_steps = 0
        self.round_ms: List[float] = []
        self.prof = None
        self.profiled = None   # (profiler, local steps, seconds) once stopped
        self.state = None

    # -- timing --------------------------------------------------------
    def _sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _now(self) -> float:
        self._sync()
        return time.monotonic()

    # -- the driver's steps ----------------------------------------------
    def train_step(self, state, batch, eta):
        import torch

        self.steps += 1
        if self.prof is not None:
            with torch.profiler.record_function("bench.local_step"):
                out = self.train_fn(state, batch, eta)
        else:
            out = self.train_fn(state, batch, eta)
        self.state, m = out
        self.losses.append(float(m["loss"]))
        if self.steps <= STEPS:
            self.readings["losses"].append(self.losses[-1])
        if self.steps == 1:
            self._read_grads()
        if self.steps == R.CHANGE_STEP:
            self._read_change()
        if self.steps <= 2:
            log(f"[bench] local step {self.steps} done at "
                f"{time.monotonic() - self.t_start:.3f} s")
        return out

    def sync_step(self, state):
        import torch

        self.rounds += 1
        timed = self.trace and self.window_open
        if timed:
            t0 = self._now()
        if self.prof is not None:
            with torch.profiler.record_function(T.ROUND_RANGE):
                out = self.sync_fn(state)
                self._sync()
        else:
            out = self.sync_fn(state)
        if timed:
            self.round_ms.append((self._now() - t0) * 1e3)
        self.state = out
        if self.rounds == 1:
            self._read_round()
        return out

    @property
    def window_open(self) -> bool:
        return self.setup_s is not None and self.window is None

    # -- the check's readings --------------------------------------------
    def _read_grads(self):
        # plain SGD with momentum 0: the moment after step 1 is the first
        # gradient, as the update took it
        mu = dict(_walk(self.state["opt"]["mu"]))
        C = self.cell.traffic["clients"]
        self.readings["grad"] = [{p: data.norm(mu[p][c]) for p in mu}
                                 for c in range(C)]
        self.readings["grad_probe"] = [
            {p: data.probe(mu[p][c], self.seed, p) for p in mu}
            for c in range(C)]

    def _changes(self) -> List[Dict[str, float]]:
        """The norm of each replica's change from the starting weights,
        a leaf at a time."""
        params = dict(_walk(self.state["params"]))
        C = self.cell.traffic["clients"]
        out = [dict() for _ in range(C)]
        for lf in self.specs:
            p0 = data.make_leaf(lf, self.seed, self.dev)
            for c in range(C):
                out[c][lf.path] = data.diff_norm(params[lf.path][c], p0)
            del p0
        return out

    def _read_change(self):
        self.readings["change"] = self._changes()

    def _read_round(self):
        self.readings["round"] = self._changes()

    # -- the feed: opens the window, profiles, closes it -----------------
    def feed(self):
        step = 0
        while True:
            step += 1
            self._before(step)
            yield data.make_batch(self.cell.model, self.cell.traffic,
                                  self.seed, step, self.dev, self.cdf)

    def _before(self, step: int):
        if self.setup_s is not None:
            self._marks.append(time.monotonic())
        if step == STEPS + 1:
            t0 = self._now()
            self._marks = [t0]     # each window step's start, for the log
            self.setup_s = t0 - self.t_start
            self._t0 = t0
            self._rounds0 = self.rounds
            log(f"[bench] set-up {self.setup_s:.3f} s; window opens at "
                f"local step {step}")
            return
        if self.setup_s is None:
            return
        if self.trace and step == PROFILE_FROM:
            self._start_profile()
        elif self.prof is not None and step == PROFILE_TO:
            self._stop_profile()
        pending = self.trace and self.profiled is None
        if not pending and time.monotonic() - self._t0 >= self.seconds:
            if self.prof is not None:
                self._stop_profile()
            t1 = self._now()
            self.window = (self._t0, t1)
            self.window_steps = step - 1 - STEPS
            gaps = [round(b - a, 3)
                    for a, b in zip(self._marks, self._marks[1:])]
            log(f"[bench] window step seconds (a round after 8, 16, ...): "
                f"{gaps}")
            raise WindowClosed()

    def _start_profile(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        t0 = self._now()
        self.prof.start()
        self._p0, self._p_steps = time.monotonic(), self.steps
        self._p_rounds = self.rounds
        self._profiler_s = self._p0 - t0

    def _stop_profile(self):
        t1 = self._now()
        prof, self.prof = self.prof, None
        prof.stop()
        self._profiler_s += time.monotonic() - t1
        self.profiled = (prof, self.steps - self._p_steps, t1 - self._p0)
        self._p_rounds = self.rounds - self._p_rounds

    def read_profile(self):
        """The stretch's record and breakdown, read after the window."""
        prof, n, wall = self.profiled
        t0 = time.monotonic()
        rec, brk = T.read(prof, RANGES, n, wall, self.cell.model,
                          self.cell.traffic)
        rec.free_steps = self.window_steps - n
        rec.free_rounds = self.rounds - self._rounds0 - self._p_rounds
        # the window less the stretch and the profiler's own start and stop
        rec.free_wall_s = (self.window[1] - self.window[0]) - wall \
            - self._profiler_s
        log(f"[bench] profiled {n} local steps and a round in {wall:.3f} s "
            f"({len(rec.kernels)} kernels); read in "
            f"{time.monotonic() - t0:.1f} s")
        return rec, brk


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run: set-up, the window, the check. Returns the result line's
    object (without the JAX check, which the command makes)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.core.stl_sgd import StagewiseDriver
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    model, traffic, train = cell.model, cell.traffic, cell.train
    cfg = spec.port_config(cell.config)
    C = traffic["clients"]
    started = not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device=dev)
    log(f"[bench] process group and mesh at "
        f"{time.monotonic() - t_start:.3f} s")
    try:
        state = build_state(cfg, model, C, train["optimizer"], seed, dev)
        log(f"[bench] state built at {time.monotonic() - t_start:.3f} s")
        train_fn, sync_fn, _ = LS.build_train_steps(
            cfg, mesh, optimizer=train["optimizer"],
            momentum=train["momentum"], reducer=train["reducer"])
        run = Run(cell, seed, seconds, trace, dev, t_start, train_fn,
                  sync_fn)
        tcfg = TrainConfig(algo=train["algo"], eta1=train["eta1"],
                           k1=train["k1"], T1=train["T1"],
                           n_stages=train["n_stages"], iid=train["iid"],
                           momentum=train["momentum"], seed=seed,
                           reducer=train["reducer"],
                           topology=train["topology"])
        # the round keeps the tags the driver prices it by
        sync_step = functools.wraps(sync_fn)(
            lambda state: run.sync_step(state))
        driver = StagewiseDriver(tcfg, run.train_step, sync_step)
        try:
            driver.run(state, run.feed())
            raise RuntimeError("the schedule ended inside the window: "
                               "give the configuration more stages")
        except WindowClosed:
            pass
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        window_losses = run.losses[STEPS:]
        del state, driver, train_fn, sync_fn, sync_step
        run.state = run.train_fn = run.sync_fn = None
    finally:
        if started:
            dist.destroy_process_group()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.monotonic()
    ref = R.readings(model, traffic, train, seed, dev)
    log(f"[bench] reference: {time.monotonic() - t0:.1f} s")
    prog = run.readings
    complete = len(prog["losses"]) == STEPS and all(
        prog[k] for k in ("grad", "change", "round", "grad_probe"))
    numbers = {k: math.inf for k in check.NUMBERS}
    if complete:
        numbers, detail = check.compare(prog, ref)
        log(f"[bench] check by step and leaf: {check.brief(detail)}")
    failed = sum(not math.isfinite(v) for v in window_losses)
    correct = check.verdict(numbers, cell.limits) and failed == 0

    t_win0, t_win1 = run.window
    window_s = t_win1 - t_win0
    out = {"correct": bool(correct), "attempted": run.window_steps,
           "failed": failed}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        out["metrics"] = {
            "train_tokens_per_s": {
                "value": run.window_steps * data.tokens_per_step(traffic)
                / window_s, "unit": "tokens/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": run.setup_s, "unit": "s"}}
        out["metrics"] = {m["name"]: out["metrics"][m["name"]]
                          for m in cell.end_to_end}
    else:
        rec, brk = run.read_profile()
        rec.round_ms = run.round_ms
        rec.update_leaves = [(math.prod(lf.shape), lf.dtype.itemsize)
                             for lf in run.specs]
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_module(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        device_info.update(busy_s=rec.busy_s, window_s=rec.wall_s)
        out["breakdown"] = brk
    out["device"] = device_info
    log(f"[bench] window {window_s:.3f} s, {run.window_steps} local steps, "
        f"{run.rounds} rounds so far; peak {peak / 2 ** 30:.3f} GiB")
    out["check"] = {k: {"value": numbers[k], "limit": v}
                    for k, v in cell.limits.items()}
    return out
