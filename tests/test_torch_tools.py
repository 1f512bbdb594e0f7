"""The port's tools (vision_assist_tpu_torch/tools/) on the CPU: the
pathfinder comparison's ``main`` runs with ``--device cpu``, prints one JSON
object last with its keys and the device's stamp, writes only where ``--out``
points, and changes nothing under diagnostics/ (the JAX rounds' records).
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import pathlib

import pytest
import torch

from vision_assist_tpu_torch.tools import _card, compare_pathfinders

REPO = pathlib.Path(__file__).resolve().parents[1]

# tool -> (tiny argv, keys its result must hold)
TOOLS = {
    "compare_pathfinders": ([], {"equal_to_exact", "rows", "scenarios"}),
}
STAMP = {"tool", "device", "nvidia_smi", "device_clock"}


def _diagnostics_digest() -> str:
    h = hashlib.sha256()
    for p in sorted((REPO / "diagnostics").rglob("*")):
        h.update(str(p.relative_to(REPO)).encode())
        if p.is_file():
            h.update(p.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every tool run once on the CPU: (printed object, --out object, files
    the run left in its own directory)."""
    before = _diagnostics_digest()
    out = {}
    for name, (argv, _) in TOOLS.items():
        work = tmp_path_factory.mktemp(name)
        target = work / "result.json"
        module = importlib.import_module(f"vision_assist_tpu_torch.tools.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert module.main(argv + ["--device", "cpu", "--out", str(target)]) == 0
        printed = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[name] = (printed, json.loads(target.read_text()),
                     sorted(p.name for p in work.iterdir()))
    assert _diagnostics_digest() == before
    return out


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_prints_its_keys_last_and_writes_only_out(results, name):
    printed, written, files = results[name]
    assert printed["tool"] == name
    assert TOOLS[name][1] | STAMP <= set(printed)
    assert printed["device"] == "cpu" and printed["nvidia_smi"] is None
    assert written == printed
    assert files == ["result.json"]


def test_out_under_diagnostics_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="diagnostics"):
        compare_pathfinders.main(["--device", "cpu", "--out",
                                  str(REPO / "diagnostics" / "pathfinders.json")])
    _card.check_out(tmp_path / "fine.json")


def test_cpu_stamp_and_percentiles():
    stamp = _card.card_stamp(torch.device("cpu"))
    assert stamp == {"device": "cpu", "nvidia_smi": None,
                     "device_clock": "host perf_counter (no card)"}
    if torch.cuda.is_available():
        assert _card.require("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _card.require("cuda")


def test_compare_pathfinders_writes_pngs(tmp_path):
    from vision_assist_tpu_torch.io.png import read_png

    with contextlib.redirect_stdout(io.StringIO()):
        assert compare_pathfinders.main(["--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    pngs = sorted(tmp_path.glob("*.png"))
    assert len(pngs) == 13
    img = read_png(pngs[0])
    assert img.shape == (64 * 20, 36 * 20, 3) and img.any()
