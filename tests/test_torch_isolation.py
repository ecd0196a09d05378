"""The port never touches JAX or the JAX package.

Three checks: no ``jax`` / ``repro`` import anywhere in the port's
sources (or in ``chip_smoke.py``, ``tools/torch_bench_diff.py`` and the
ported examples under ``examples_torch/``); a
fresh interpreter that imports every port module ends with no ``jax*`` or ``repro.*`` module loaded; and the
port's entry points (``core.simulate.run``, ``runtime.run``, the CNN
initializers, the training builders and launcher, each example's
``main``) refuse to run without CUDA unless asked for the CPU.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jax_replay import load_example

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "repro"
            or name.startswith("repro."))


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "tools" /
                                           "torch_bench_diff.py"] + EXAMPLES
    assert len(files) > 30
    assert [f.stem for f in EXAMPLES] == sorted(
        f.stem for f in (ROOT / "examples").glob("*.py"))
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.simulate" in mods
    assert "repro_torch.runtime.runtime" in mods
    assert "repro_torch.kernels.quantize.kernel" in mods
    assert "repro_torch.models.cnn" in mods
    assert "repro_torch.engine.topology" in mods
    for m in ("models.moe", "models.attention", "configs.gemma3_12b",
              "configs.minicpm3_4b", "configs.phi35_moe",
              "configs.deepseek_v2_236b", "models.rglru",
              "configs.recurrentgemma_2b", "configs.internvl2_2b",
              "configs.musicgen_medium",
              "optim.sgd", "checkpoint.ckpt", "core.local_sgd",
              "core.stl_sgd", "core.baselines", "launch.train",
              "launch.serve", "obs.export", "obs.profile", "obs.diff",
              "obs.slo", "sharding.rules", "launch.mesh", "launch.specs",
              "launch.collectives", "launch.dryrun", "comm.shards",
              "kernels.trace"):
        assert f"repro_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "0 []", out.stdout + out.stderr


def test_run_without_device_needs_cuda():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.models import logreg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() would use it")
    data = {"x": torch.zeros(2, 8, 4), "y": torch.ones(2, 8)}
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.run(lambda p, b: logreg.loss_fn(p, b, 0.0),
                     logreg.init_params(4), data, TrainConfig(T1=4, k1=2.0,
                                                              n_stages=1),
                     lambda p: torch.zeros(()))
    from repro_torch import runtime

    for cfg in (TrainConfig(T1=4, k1=2.0, n_stages=1),
                TrainConfig(T1=4, k1=2.0, n_stages=1, async_mode=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime.run(lambda p, b: logreg.loss_fn(p, b, 0.0),
                        logreg.init_params(4), data, cfg,
                        lambda p: torch.zeros(()))
        res = runtime.run(lambda p, b: logreg.loss_fn(p, b, 0.0),
                          logreg.init_params(4), data, cfg,
                          lambda p: torch.zeros(()), device="cpu")
        assert res.wall_clock_s > 0.0
    from repro_torch.models import cnn

    for init in (cnn.init_resnet18, cnn.init_vgg16):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(0, width=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.resolve_device("cuda")
    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd
    from repro_torch.launch import train

    cfg = get_arch("qwen3-14b", smoke=True)
    for call in (lambda: local_sgd.build_train_steps(cfg),
                 lambda: local_sgd.init_state(0, cfg, 2),
                 lambda: next(train.synthetic_batches(cfg, 2, 1, 8)),
                 lambda: train.main(["--arch", "qwen3-14b", "--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert simulate.resolve_device("cpu").type == "cpu"


def test_mesh_entry_points_need_cuda():
    """``make_host_mesh`` / ``make_host_pod_mesh`` mean CUDA and refuse
    without it (before any process group starts) unless asked for the
    CPU; the mesh route builds on the mesh's device, no other."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the meshes would use it")
    for call in (lambda: mesh.make_host_mesh(1, 1),
                 lambda: mesh.make_host_pod_mesh(1, 1, 1),
                 lambda: mesh.make_host_mesh(1, 1, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        mesh.make_host_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()
    m = mesh.make_host_mesh(1, 1, device="cpu")
    try:
        assert m.device_type == "cpu"
        assert tuple(m.mesh_dim_names) == ("data", "model")
        # a second call reuses the group; a fake mesh refuses a real one
        assert mesh.make_host_mesh(1, 1, device="cpu").size() == 1
        with pytest.raises(RuntimeError, match="real process group"):
            mesh.make_fake_mesh((2, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_main_needs_cuda(path):
    """Each ported example runs on CUDA by default and raises without it,
    ``--device cuda`` as well: no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run")
    mod = load_example(path.stem)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
