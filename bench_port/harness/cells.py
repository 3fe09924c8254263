"""Cells by name: a workload of ``BENCHMARK.json`` names a configuration
and a traffic mix, each a JSON file of its own under ``configs/`` and
``traffic/``; per-layer metrics are readers under ``metrics/``, and the
check's readers, one a layer, under ``checks/``, one file each, found by
name. Nothing here knows a cell, a mix, a metric or a layer by name."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # bench_port/
ROOT = HERE.parent                              # the checkout


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files read; raises KeyError for a name the
    file does not hold."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(workload, w["config"], w["traffic"], config, traffic,
                w["chips"],
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


@functools.lru_cache(maxsize=None)
def _module(kind: str, name: str, root: Path = ROOT):
    """``<kind>/<name>.py`` of the benchmark's folder, loaded once."""
    path = root / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} reader {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<name>.py``: it returns the
    metric's value, or None where the run gave it nothing to read."""
    return _module("metrics", name, root).read


def check_reader(name: str, root: Path = ROOT):
    """The module ``checks/<name>.py``: the program entries its layer's
    check hooks (``HOOKS``, (module, function) pairs) and
    ``read(cap, exact, low, control, system)``, its numbers, or an empty
    dict where the captured segment made no call of those entries."""
    return _module("checks", name, root)
