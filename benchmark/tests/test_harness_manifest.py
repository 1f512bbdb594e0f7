"""BENCHMARK.json against the rules a check holds it to: names, units,
keys, and that every piece it names exists where the harness looks."""

import json
import math
import re

import pytest
from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        def reports(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(m) for m in MANIFEST["per_layer"]), w["name"]


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_every_cell_the_metric_lists(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    cells = metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
    for cell in cells:
        assert "workloads" not in moved or cell in moved["workloads"], (metric["name"], cell)


def test_layers_are_spelled_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    lowered = {}
    for layer in layers:
        assert lowered.setdefault(layer.lower(), layer) == layer


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_exist(cell):
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    assert cell["config"] in configs
    bench = ROOT / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (bench / "loops" / f"{traffic['serving']}.py").exists()
    limits = json.loads((bench / "limits" / f"{cell['name']}.json").read_text())
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in limits.values())


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    weights = data["weights"]
    if isinstance(weights, dict):
        assert set(weights) == {"seed"} and isinstance(weights["seed"], int), weights
    else:
        assert (ROOT / weights).is_file(), weights
    if "reference" in data:
        assert (ROOT / "benchmark" / "reference" / f"{data['reference']}.py").is_file()
    reduced = config["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16
    assert all(isinstance(k, str) and 1 <= len(k) <= 200 for k in reduced), reduced
    if reduced:
        assert "published" in data and "deployment" in data, config["name"]
    assert sum(w["config"] == config["name"] for w in MANIFEST["workloads"]) >= 1


def test_config_traffic_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
