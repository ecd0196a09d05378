"""The port never touches JAX or the JAX package.

Three checks: no ``jax`` / ``repro`` import anywhere in the port's
sources (or in ``chip_smoke.py``); a fresh interpreter that imports every
port module ends with no ``jax*`` or ``repro.*`` module loaded; and the
port's entry point refuses to run without CUDA unless asked for the CPU.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.simulate" in mods
    assert "repro_torch.kernels.quantize.kernel" in mods
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
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.resolve_device("cuda")
    assert simulate.resolve_device("cpu").type == "cpu"
