"""Port parity for the model-in-the-loop goldens: the port's
``generate_video_golden.run_sequence`` and ``generate_model_goldens``'s
one-shot records against the JAX scripts' on the same PNG frames.

The frames are the six ``assets/demo`` PNGs and four seeded walkways written
as PNG (the images the committed fixtures were pinned on are not in the
repository), through yolov8n-seg at imgsz 640 with
``v8n_640_best.msgpack``, in float32 on both sides (the dtype of the
pipeline parity tests; JAX's scripts default to bf16, so its ModelConfig is
patched to float32 for the call). The per-frame dicts must be equal. The
sequence is cut to these ten frames here; the script plays 16.

The committed ``model_goldens.json`` and ``video_golden.json`` are replayed
through the port under exactly the JAX replay tests' skip condition
(tests/test_model_goldens.py, tests/test_video_golden.py): weights, fixture
and validation images present, the weights' hash the pinned one.
"""

from __future__ import annotations

import functools
import hashlib
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu_torch import generate_model_goldens, generate_video_golden  # noqa: E402
from vision_assist_tpu_torch.io.png import write_png  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "assets" / "weights" / "v8n_640_best.msgpack"
FIXTURES = REPO / "tests" / "fixtures"


@pytest.fixture(scope="module")
def jax_scripts():
    """scripts/generate_video_golden.py, imported as tests/test_video_golden.py
    imports it, and its frame directory (the JAX replay tests' condition)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import generate_video_golden as jvideo
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return jvideo


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The six demo PNGs and four seeded 640x640 walkways written as PNG."""
    root = tmp_path_factory.mktemp("golden_frames")
    for p in sorted((REPO / "assets" / "demo").glob("*.png")):
        shutil.copy(p, root / p.name)
    for i, frame in enumerate(walkway_frames(4, 640, 640, seed=12)):
        write_png(root / f"walkway_{i:02d}.png", frame)
    return sorted(root.glob("*.png"))


@pytest.fixture
def jax_float32(monkeypatch):
    monkeypatch.setattr(jconfig, "ModelConfig",
                        functools.partial(jconfig.ModelConfig, dtype="float32"))


def _jax_one_shot(paths):
    """scripts/generate_model_goldens.py's loop, as tests/test_model_goldens.py
    replays it, on ``paths``."""
    from vision_assist_tpu.models.checkpoint import load_variables
    from vision_assist_tpu.models.inference import Segmenter
    from vision_assist_tpu.pipeline.frame_processor import FrameProcessor

    cfg = jconfig.PipelineConfig(frame_height=640, frame_width=640)
    seg = Segmenter(jconfig.ModelConfig(imgsz=640), variables=load_variables(WEIGHTS),
                    example_hw=(640, 640), grid_size=cfg.grid.grid_size)
    fp = FrameProcessor(cfg, segmenter=seg)
    records = {}
    for p in paths:
        frame = cv2.imread(str(p))
        if frame.shape[:2] != (640, 640):
            frame = cv2.resize(frame, (640, 640))
        res = fp(frame, now_ms=0)
        fp.analyser.previous_instructions.clear()
        records[p.name] = {
            "final_answer": res.final_answer,
            "n_detections": int(res.n_detections),
            "n_peaks": len(res.peaks),
            "n_paths": len(res.paths),
            "walkable_cells": int(res.walkable.sum()),
        }
    return records


def test_run_sequence_equals_jax(jax_scripts, frames, jax_float32):
    want = jax_scripts.run_sequence(frames, WEIGHTS)
    got = generate_video_golden.run_sequence(frames, WEIGHTS, device="cpu",
                                             dtype="float32")
    assert got == want
    assert max(f["memory_timestamps"] for f in got) > 1
    assert any(f["n_detections"] for f in got) and any(f["n_paths"] for f in got)


def test_one_shot_records_equal_jax(frames, jax_float32):
    want = _jax_one_shot(frames)
    got = generate_model_goldens.one_shot_records(frames, WEIGHTS, device="cpu",
                                                  dtype="float32")
    assert got == want
    assert any(r["n_peaks"] for r in got.values())


def test_scripts_write_only_out(tmp_path, frames, capsys):
    """Both command lines on two frames with --device cpu (bf16, as the
    scripts run): the JSON written to --out only, its keys the JAX files'."""
    src = tmp_path / "frames"
    src.mkdir()
    for p in frames[-2:]:
        shutil.copy(p, src / p.name)
    before = sorted(REPO.joinpath("tests", "fixtures").iterdir())
    video, model = tmp_path / "video.json", tmp_path / "model.json"
    assert generate_video_golden.main(["--images", str(src), "--out", str(video),
                                       "--device", "cpu"]) == 0
    assert generate_model_goldens.main(["--images", str(src), "--out", str(model),
                                        "--device", "cpu"]) == 0
    doc = json.loads(video.read_text())
    assert doc.keys() == json.loads((FIXTURES / "video_golden.json").read_text()).keys()
    assert doc["weights_sha256"] == hashlib.sha256(WEIGHTS.read_bytes()).hexdigest()
    assert [f["image"] for f in doc["frames"]] == [p.name for p in frames[-2:]]
    mdoc = json.loads(model.read_text())
    assert mdoc.keys() == json.loads((FIXTURES / "model_goldens.json").read_text()).keys()
    assert sorted(mdoc["images"]) == [p.name for p in frames[-2:]]
    assert sorted(REPO.joinpath("tests", "fixtures").iterdir()) == before
    for main in (generate_video_golden.main, generate_model_goldens.main):
        with pytest.raises(SystemExit):
            main(["--images", str(src)])            # --out is required
    capsys.readouterr()


def _as_png(paths, root):
    """The validation images decoded by cv2 and written as PNG (the port
    reads PNG only), in order."""
    root.mkdir(exist_ok=True)
    out = []
    for p in paths:
        out.append(root / f"{p.stem}.png")
        write_png(out[-1], cv2.imread(str(p)))
    return out


def _pinned(jax_scripts, fixture):
    """The fixture's document, or a skip under the JAX replay test's
    condition: the weights, the fixture and the validation images present,
    the weights' hash the pinned one."""
    golden = FIXTURES / fixture
    if not (WEIGHTS.exists() and golden.exists() and jax_scripts.VAL_IMAGES.exists()):
        pytest.skip("needs trained weights + pinned goldens + the reference dataset")
    doc = json.loads(golden.read_text())
    if hashlib.sha256(WEIGHTS.read_bytes()).hexdigest() != doc["weights_sha256"]:
        pytest.skip("weights changed since the goldens were pinned")
    return doc


def test_committed_video_golden_replays(jax_scripts, tmp_path):
    golden = _pinned(jax_scripts, "video_golden.json")
    paths = [jax_scripts.VAL_IMAGES / f["image"] for f in golden["frames"]]
    got = generate_video_golden.run_sequence(_as_png(paths, tmp_path / "png"), WEIGHTS,
                                             device="cpu")
    assert [dict(f, image=p.name) for f, p in zip(got, paths)] == golden["frames"]
    assert max(f["memory_timestamps"] for f in got) > 1


def test_committed_model_goldens_replay(jax_scripts, tmp_path):
    golden = _pinned(jax_scripts, "model_goldens.json")
    paths = [jax_scripts.VAL_IMAGES / n for n in golden["images"]
             if (jax_scripts.VAL_IMAGES / n).exists()]
    assert len(paths) >= 4, "too few golden images resolved"
    got = generate_model_goldens.one_shot_records(_as_png(paths, tmp_path / "png"),
                                                  WEIGHTS, device="cpu")
    assert list(got.values()) == [golden["images"][p.name] for p in paths]


def test_read_frame_resizes_as_cv2(tmp_path):
    """A frame of another size is resized to 640x640 within one grey level
    of cv2.resize's bilinear (the port's resize, data/augment.py)."""
    frame = walkway_frames(1, 480, 720, seed=3)[0]
    write_png(tmp_path / "f.png", frame)
    got = generate_video_golden.read_frame(tmp_path / "f.png")
    want = cv2.resize(frame, (640, 640))
    assert got.shape == (640, 640, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
