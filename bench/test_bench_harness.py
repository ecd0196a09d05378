"""CPU tests of the benchmark (``bench/``): the manifest and its files, the
frozen arithmetic against the port's, a cell's run through the plain
routes at SMOKE size, the reference against the port, the control and the
faults that the check must refuse, and the imports.

The command itself needs a card; these tests drive ``harness.run_cell``
on the CPU instead, with each cell's model cut to its arch's SMOKE sizes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [p for p in (str(ROOT / "src"), str(ROOT)) if p not in sys.path]

from bench import check, faults, flops, harness, spec  # noqa: E402
from bench.reference import control  # noqa: E402
from bench.reference import train as R  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2 ** 31 + 11
# the control's SMOKE depth: at 2 layers the float8 control's error in the
# check's numbers is still building up, at 8 it reads as at full depth
CONTROL_LAYERS = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """SMOKE sizes gain nothing from many CPU threads; the worker's count
    is put back after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smoke_cell(name: str, dtype: str = "bfloat16",
               layers: int = None) -> spec.Cell:
    """The cell with its model at its arch's SMOKE sizes (``layers`` deep
    if given) and short rows."""
    from repro_torch.configs import get_arch

    cell = spec.cell(ROOT, name)
    m = cell.config["model"]
    small = get_arch(cell.config["arch"], smoke=True)
    m.update(n_layers=layers or small.n_layers, d_model=small.d_model,
             d_ff=small.d_ff, vocab_size=small.vocab_size, dtype=dtype)
    if small.ssm is not None:
        m["ssm"] = dict(small.ssm.__dict__)
        cell.traffic["tokens_per_row"] = 2 * small.ssm.chunk_size
    if small.attention is not None:
        m["attention"] = dict(m["attention"], n_heads=small.attention.n_heads,
                              n_kv_heads=small.attention.n_kv_heads,
                              head_dim=small.attention.head_dim)
        cell.traffic["tokens_per_row"] = 48
    if small.frontend:
        m.update(n_frontend_tokens=small.n_frontend_tokens,
                 frontend_dim=small.frontend_dim)
        cell.traffic["frontend_frames"] = small.n_frontend_tokens
    return cell


def run(cell, trace=False, seed=SEED):
    import time

    return harness.run_cell(cell, seed, 0.0, trace, "cpu", time.monotonic())


# ---------------------------------------------------------------------------
# The manifest and its files
# ---------------------------------------------------------------------------

def test_manifest_names_units_and_keys():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + CELLS + [
        x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in m["workloads"]]:
        assert spec.NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert spec.UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in (
            "host_clock", "device_trace")
    assert {"setup_s"} <= {x["name"] for x in m["end_to_end"]}
    for w in m["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for c in m["configs"]:
        assert c["file"].startswith("bench/") and 0 < len(c["why"]) <= 200
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
        assert set(x["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = spec.cell(ROOT, name)
    assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
    assert cell.config["name"] == [w for w in MANIFEST["workloads"]
                                   if w["name"] == name][0]["config"]
    assert {m["name"] for m in cell.per_layer} and cell.end_to_end
    for c in MANIFEST["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("metric", [x["name"] for x in MANIFEST["per_layer"]])
def test_metric_module_matches_the_manifest(metric):
    mod = spec.metric_module(metric)
    entry = [x for x in MANIFEST["per_layer"] if x["name"] == metric][0]
    assert (mod.unit, mod.layer, mod.moves, mod.workloads) == (
        entry["unit"], entry["layer"], entry["moves"], entry["workloads"])


# ---------------------------------------------------------------------------
# The frozen arithmetic equals the port's today
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", CELLS)
def test_frozen_flops_equal_the_ports(name, smoke):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import trace as KT
    from repro_torch.launch.flops import count_params, shape_flops

    cell = smoke_cell(name) if smoke else spec.cell(ROOT, name)
    cfg = spec.port_config(cell.config)
    rows, S = 4, cell.traffic["tokens_per_row"]
    rep = shape_flops(cfg, ShapeConfig("bench", S, rows, "train"))
    assert flops.matmul_params(cell.model) == count_params(cfg)[1]
    assert flops.mixing_flops(cell.model, rows, S) == rep.breakdown["attn"]
    assert 6.0 * flops.matmul_params(cell.model) * rows * S == \
        pytest.approx(rep.model_flops, rel=1e-12)
    for n in (1, 64, 1756):
        assert flops.masked_pairs(n) == KT.masked_pairs(n, None, "full")
    assert flops.ssd_flops(2, 1024, 80, 64, 1, 128, 256) == KT.ssd_flops(
        2, 1024, 80, 64, 1, 128, 256)


# ---------------------------------------------------------------------------
# A cell's run on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_smoke_cell_runs_and_its_line_has_the_keys(name):
    cell = smoke_cell(name)
    out = run(cell)
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    # no device memory on the CPU: the peak reads 0 there
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"], (k, v)


def test_traced_smoke_run_reports_per_layer_metrics():
    cell = smoke_cell(CELLS[0])
    out = run(cell, trace=True)
    assert out["correct"] is True
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == "", p.stderr


# ---------------------------------------------------------------------------
# The reference, the control and the faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_in_float32(name):
    """In float32 the port and the reference compute one function: every
    number is at rounding."""
    out = run(smoke_cell(name, "float32"))
    for k, v in out["check"].items():
        assert v["value"] < 1e-5, (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference with float8 products in the program's place fails the
    cell's limits."""
    cell = smoke_cell(name, layers=CONTROL_LAYERS)
    ref = R.readings(cell.model, cell.traffic, cell.train, SEED, "cpu")
    ctl = R.readings(cell.model, cell.traffic, cell.train, SEED, "cpu",
                     control.fp8_matmul)
    ctl["round"] = [ctl["round"]] * cell.traffic["clients"]
    assert not check.verdict(check.compare(ctl, ref)[0], cell.limits)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    """The run, its look for a card skipped, with the program's step or
    round broken underneath (``bench/faults.py``): a step that leaves its
    state unchanged, one that drops half of each client's batch, a round
    that averages nothing."""
    with faults.planted(faults.FAULTS[fault]):
        out = run(smoke_cell(name))
    assert out["correct"] is False, out["check"]


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------

IMPORT_CHECK = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
import bench.test_bench_harness as t
from bench import harness, spec
for m in spec.manifest(t.ROOT)["per_layer"]:
    spec.metric_module(m["name"])
import bench.calibrate, bench.run
t.run(t.smoke_cell(t.CELLS[0]))
bad = sorted({{m.split(".")[0] for m in sys.modules}} &
             {{"jax", "jaxlib", "flax", "repro"}})
print(bad)
"""

REFERENCE_CHECK = """
import sys
sys.path[:0] = [{root!r}]
from bench import data
from bench.reference import control, model, train
bad = sorted({{m.split(".")[0] for m in sys.modules}} &
             {{"jax", "jaxlib", "flax", "repro", "repro_torch"}})
print(bad)
"""


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    """Top-level names compare whole: ``repro_torch`` is not ``repro``."""
    code = IMPORT_CHECK.format(src=str(ROOT / "src"), root=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = REFERENCE_CHECK.format(root=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
