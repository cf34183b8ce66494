"""Finds a cell's parts by name, so that a cell, a configuration, a traffic
mix, a generator or a metric is added as files and entries only.

``BENCHMARK.json``, at the root of the checkout, is the one list of cells
and metrics: a cell's configuration, traffic mix and chips, and which
metrics each cell reports (an end-to-end metric in the cells its
``workloads`` lists, or in every cell; a per-layer metric in the cells its
``workloads`` lists, or in every cell that reports the metric it
``moves``).  The parts it names are files of this folder:

* the configuration's ``file``: the deployment's settings (``system.py``);
* ``traffic/<traffic>.json``: the mix's parameters, among them the name of
  its ``generator``;
* ``traffic/<generator>.py``: ``make_objects(params, seed)``, the cell's
  pool of objects;
* ``metrics/<metric>.py``: ``read(run)``, one reader a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]          # metric name -> unit


def benchmark(root: Path = HERE) -> dict:
    """``BENCHMARK.json`` of the checkout that holds ``root``."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        raise LookupError(f"no {path}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise LookupError(f"no file {path}")
    return json.loads(path.read_text())


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise LookupError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "codecbench_" + path.parent.name + "_"
        + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = HERE) -> Cell:
    bench = benchmark(root)
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise LookupError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == spec["config"])
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e)]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name=name, config=_json(root.parent / config["file"]),
                traffic=_json(root / "traffic" / f"{spec['traffic']}.json"),
                chips=int(spec["chips"]), end_to_end=e2e,
                per_layer=per_layer, units=units)


def generator(traffic: dict, root: Path = HERE) -> Callable:
    """The ``make_objects(params, seed)`` that a traffic mix names."""
    return _module(root / "traffic" / f"{traffic['generator']}.py") \
        .make_objects


def metric_reader(name: str, root: Path = HERE) -> Callable:
    """The ``read(run)`` of metric ``name``."""
    return _module(root / "metrics" / f"{name}.py").read
