"""A cell's pieces, found by the names ``BENCHMARK.json`` gives them.

* ``BENCHMARK.json``: the cell's configuration and traffic names, and the
  metrics, each reported in the cells its ``workloads`` key lists (in every
  cell without one);
* ``benchmark/configs/<config>.json``: the model configuration as it runs;
* ``benchmark/traffic/<traffic>.json``: the traffic mix, parameters that the
  one frame generator and the serving loop it names read;
* ``benchmark/loops/<serving>.py``: one serving loop, a subclass of
  ``harness.serve.Loop``;
* ``benchmark/limits/<cell>.json``: the limits of the numbers ``correct``
  compares, set from readings of the program and of the control;
* ``benchmark/reference/<reference>.py``: the configuration's plain
  reference model, named by its ``"reference"`` key (``yolo`` without one);
* ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  which returns its value, or None where the run has nothing to read.

A later cell, configuration, traffic mix or metric is a new file and a new
entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]      # the manifest's entries this cell reports
    per_layer: list[dict]


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reported_in(m, name)])


def load_module(root: pathlib.Path, kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, registered under a name of
    its own (dataclasses look their module up by name); run once a process,
    later calls for the same file get the same module."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{kind}_{name.replace('.', '_')}", path)
    loaded = sys.modules.get(spec.name)
    if loaded is not None and loaded.__file__ == spec.origin:
        return loaded
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def reference_module(root: pathlib.Path, config: dict):
    """The plain reference of a configuration: the module
    ``benchmark/reference/<config["reference"]>.py``, ``yolo`` where the
    configuration names none."""
    return load_module(root, "reference", config.get("reference", "yolo"))


def metric_reader(root: pathlib.Path, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return load_module(root, "metrics", name).read
