"""The run command on a machine without a CUDA card: it exits with a code
other than 0 and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    assert "CUDA card" in proc.stderr


def test_an_unknown_cell_is_refused():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no.such.cell", "--seed", "1",
         "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL,
         "--seed", str(2 ** 31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
