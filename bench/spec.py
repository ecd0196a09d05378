"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a file found by name:

* ``bench/configs/<config>.json``: the port's arch name, its source, the
  model's sizes as run, the training schedule, ``reduced`` / ``assumed``
  and the deployment it stands for;
* ``bench/traffic/<traffic>.json``: clients, rows and tokens a local
  step, frontend frames, the token distribution;
* ``bench/limits/<workload>.json``: the limit of each number the check
  compares;
* ``bench/metrics/<metric>.py``: a per-layer metric's reader, a module
  exposing ``name``, ``unit``, ``layer``, ``moves``, ``workloads`` and
  ``read(record)``, which returns a number or None.

Adding a cell, a mix or a metric adds files; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # the check's limits
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def train(self) -> dict:
        return self.config["train"]


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its files
    read."""
    man = manifest(root)
    found = [w for w in man["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in man['workloads']]}")
    w = found[0]

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    def data_file(folder, name):
        return load_json(BENCH / folder / f"{checked_name(name)}.json")

    return Cell(
        name=workload,
        config=data_file("configs", w["config"]),
        traffic=data_file("traffic", w["traffic"]),
        limits=data_file("limits", workload),
        chips=w["chips"],
        end_to_end=[m for m in man["end_to_end"] if mine(m)],
        per_layer=[m for m in man["per_layer"] if mine(m)])


def metric_module(name: str):
    """The reader module ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{checked_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.name != name:
        raise ValueError(f"{path} defines metric {mod.name!r}")
    return mod


def port_config(config: dict):
    """The port's ``ArchConfig`` as the configuration file runs it: the
    registry's entry for ``arch`` with every size of the file's ``model``
    put in."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import base

    groups = {"ssm": base.SSMConfig, "attention": base.AttentionConfig}
    kw = {}
    for k, v in config["model"].items():
        if k in groups and v is not None:
            v = groups[k](**v)
        elif k == "block_pattern":
            v = tuple(v)
        kw[k] = v
    return get_arch(config["arch"]).replace(**kw)
