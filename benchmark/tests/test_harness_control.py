"""The check's precision control comes out not correct: the reference with
its convolution and matmul operands in float8 (the configuration states
bf16), and the planner one precision step down, fail at least one of the
cell's limits. On the card it runs at the cells' own size
(``benchmark/control.py``); here on eight frames of a scenes seed on
which yolov8n-seg@640 detects a walkway in three (best scores 0.63-0.78)."""

import json

import torch
from conftest import CPU_SEED, ROOT, cpu_root

from benchmark.control import control_numbers
from benchmark.harness.cell import load_cell


def _failed(numbers, limits):
    return {k: v for k, v in numbers.items() if k in limits and v > limits[k]}


def test_float8_segmenter_fails_a_limit(tmp_path):
    root = cpu_root(tmp_path, pool=8, scenes_seed=26)
    cell = load_cell(root, "cpu.sync")
    numbers = control_numbers(root, cell, 26, torch.device("cpu"))
    failed = _failed(numbers, cell.limits)
    assert {"conf_gap", "occ_share"} & set(failed), numbers


def test_bf16_planner_fails_the_device_planner_limits(tmp_path):
    root = cpu_root(tmp_path)
    cell = load_cell(root, "cpu.batch2")
    numbers = control_numbers(root, cell, CPU_SEED, torch.device("cpu"))
    failed = _failed(numbers, cell.limits)
    assert {"field_gap", "cost_gap"} & set(failed), numbers


def test_every_cell_has_a_limit_for_every_number():
    from benchmark.harness.check import numbers_of

    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cell = load_cell(ROOT, w["name"])
        assert set(cell.limits) == set(numbers_of(cell.config)), w["name"]
