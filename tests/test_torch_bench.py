"""The port's bench (``vision_assist_tpu_torch/bench.py``) and its timing
tools (``utils/profiling.py``) against the JAX package's:

* ``load_frames`` without a directory is the repository bench's synthetic
  band frames, bit for bit; with one, the PNG files as ``read_png`` reads
  them, topped up with the seeded walkways;
* ``run_bench`` at a small count on the CPU prints one JSON line with the
  repository bench's keys plus ``p99_ms`` and ``power_limit_w``, and its
  answers and detections equal JAX's ``FrameProcessor`` on the same frames in
  the same order (the flagship in bfloat16 on both sides, as served);
* ``StageTimer``: the same samples give byte-equal ``write`` and
  ``write_samples`` files and an equal ``summary``;
* ``device_trace`` writes a Chrome trace, and on a missing card raises.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.models import flagship as jflagship  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu.utils.profiling import StageTimer as JaxStageTimer  # noqa: E402
from vision_assist_tpu_torch import bench  # noqa: E402
from vision_assist_tpu_torch.io.png import read_png  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.utils.profiling import StageTimer, device_trace  # noqa: E402

torch.set_num_threads(2)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ms", "p90_ms",
            "pipeline_depth", "batched_fps_8streams", "frames_with_detections",
            "weights", "model", "engine", "transfer_format", "source", "device"}


@pytest.fixture(scope="module")
def root_bench(tmp_path_factory):
    """The repository's bench.py, its real-photo directory pointed at a path
    that does not exist (the synthetic branch)."""
    sys.path.insert(0, str(REPO_ROOT))
    import bench as root

    saved = root.VAL_IMAGES
    root.VAL_IMAGES = tmp_path_factory.mktemp("none") / "absent"
    yield root
    root.VAL_IMAGES = saved


@pytest.mark.parametrize("n,hw", [(30, (640, 640)), (3, (64, 96)), (1, (321, 207))])
def test_load_frames_without_a_directory_is_the_root_bench(root_bench, n, hw):
    got, want = bench.load_frames(n, hw), root_bench.load_frames(n, hw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_load_frames_reads_the_demo_pngs_then_walkways():
    frames = bench.load_frames(9, (640, 640), bench.DEMO_DIR)
    demo = sorted(bench.DEMO_DIR.glob("*.png"))
    assert len(demo) == 6
    for frame, path in zip(frames, demo):
        np.testing.assert_array_equal(frame, read_png(path))
    np.testing.assert_array_equal(frames[6:], walkway_frames(3, 640, 640, seed=0))
    # A directory of frames of another size: resized to the bench's.
    small = bench.load_frames(2, (320, 320), bench.DEMO_DIR)
    assert small.shape == (2, 320, 320, 3)


def _jax_answers(frames, n_warmup):
    """JAX's FrameProcessor over the bench's synchronous sequence."""
    cfg = jconfig.PipelineConfig(frame_height=640, frame_width=640,
                                 transfer_format="i420")
    seg = JaxSegmenter(jflagship.model_config(),
                       variables=jflagship.load_flagship_variables(),
                       example_hw=(640, 640), grid_size=cfg.grid.grid_size)
    fp = JaxFrameProcessor(cfg, segmenter=seg)
    for i in range(n_warmup):
        fp(frames[i % len(frames)], now_ms=i * 33)
    out = []
    for i, frame in enumerate(frames):
        res = fp(frame, now_ms=1000 + i * 33)
        out.append((res.final_answer, res.n_detections > 0))
    return out


def test_run_bench_small_on_the_cpu_matches_jax(capsys):
    """8 frames (6 demo PNGs, 2 walkways), depth 2, 2 streams, 2 steps."""
    record, answers = bench.run_bench(n_frames=8, n_throughput=4, depth=2,
                                      streams=2, steps=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == record
    assert set(printed) == JAX_KEYS | {"p99_ms", "power_limit_w"}
    assert printed["device"] == "cpu" and printed["power_limit_w"] is None
    assert (printed["model"], printed["engine"], printed["transfer_format"],
            printed["pipeline_depth"]) == ("yolo11n-seg@256", "exact", "i420", 2)
    assert printed["weights"] == jflagship.flagship()["asset"]
    assert printed["source"] == "6 PNG frames of assets/demo + 2 synthetic walkways (seed 0)"
    for key in ("value", "p50_ms", "p90_ms", "p99_ms", "batched_fps_8streams"):
        assert np.isfinite(printed[key]) and printed[key] > 0, key
    assert printed["p50_ms"] <= printed["p90_ms"] <= printed["p99_ms"]
    assert printed["vs_baseline"] == pytest.approx(printed["value"] * 0.24)

    frames = bench.load_frames(8, (640, 640), bench.DEMO_DIR)
    want = _jax_answers(frames, n_warmup=2)
    assert answers == [a for a, _ in want]
    assert printed["frames_with_detections"] == f"{sum(d for _, d in want)}/8"


def test_run_bench_needs_as_many_frames_as_streams():
    with pytest.raises(ValueError, match="streams"):
        bench.run_bench(n_frames=2, streams=4, device="cpu")


def _timers(cls):
    t = cls()
    for i in range(5):
        t.add_sample("segment", 0.01 * (i + 1) / 3)
        t.add_sample("plan", 1e-3 * (7 - i))
        t.add_sample("plan", 2.5e-4)
        if i == 3:
            t.add_sample("host", 0.125)
        t.end_frame()
    return t


def test_stage_timer_files_are_byte_equal_to_jax(tmp_path):
    got, want = _timers(StageTimer), _timers(JaxStageTimer)
    assert got.summary() == want.summary()
    got.write(tmp_path / "port.txt")
    want.write(tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    got.write_samples(tmp_path / "port.json")
    want.write_samples(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_stage_timer_drops_an_outlier_frame_as_jax_does():
    for cls in (StageTimer, JaxStageTimer):
        t = cls(outlier_threshold_s=0.0)
        with t.stage("a"):
            pass
        t.end_frame()
        t2 = cls(outlier_threshold_s=10.0)
        with t2.stage("a"):
            pass
        t2.end_frame()
        assert (dict(t.samples), len(t2.samples["a"])) == ({}, 1), cls


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace", device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with device_trace(tmp_path):
            pass
