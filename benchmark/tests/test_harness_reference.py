"""The plain reference against the port at full size on the CPU, both in
float32: the segmenter chain on two 1280x720 walkways of each
configuration, and the planner on lattices the port serves."""

import json
import time

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark.harness.check import reference_segmentation
from benchmark.harness.frames import walkway_pool
from benchmark.harness.weights import flax_tree

CONFIGS = ["yolo11n-seg-256", "yolov8n-seg-640"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_segmenter_equals_the_port_in_float32(name):
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models.checkpoint import load_variables
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host, i420_to_bgr

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    frames = walkway_pool(2, 1280, 720, seed=10)
    t0 = time.perf_counter()
    ref = reference_segmentation(ROOT, cfg, flax_tree(ROOT, cfg, "cpu"), frames,
                                 torch.device("cpu"))
    ref_s = (time.perf_counter() - t0) / len(frames)
    seg = Segmenter(ModelConfig(arch=cfg["arch"], imgsz=cfg["imgsz"], dtype="float32"),
                    variables=load_variables(ROOT / cfg["weights"]), example_hw=(1280, 720),
                    device="cpu")
    for f, r in zip(frames, ref):
        wire = i420_to_bgr(torch.from_numpy(bgr_to_i420_host(f)), 1280, 720)
        out = seg(wire)
        assert int(out.detections.valid.sum()) == r.n_detections
        assert np.array_equal(out.occupancy.numpy(), r.occupancy)
        best = float(out.detections.scores.max()) if r.n_detections else 0.0
        assert abs(best - r.best_conf) < 1e-4
    print(f"reference segmenter on the CPU: {ref_s:.3f} s a frame ({name})")


def test_reference_planner_equals_the_port_on_served_lattices():
    from vision_assist_tpu_torch.config import PipelineConfig
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    from benchmark.reference.plan import ReferencePlanner, peak_tuple

    rng = np.random.default_rng(4)
    fp = FrameProcessor(PipelineConfig(), device="cpu")
    ref = ReferencePlanner((1280, 720), 20, device_astar=False)
    scenarios = sorted((ROOT / "tests" / "fixtures" / "scenarios").glob("*_grids.npy"))
    lattices = [np.load(p).astype(bool) for p in scenarios]
    lattices += [rng.random((64, 36)) < 0.6 for _ in range(4)]
    for i, occ in enumerate(lattices):
        got = fp.process_occupancy(occ, now_ms=33 * i)
        want = ref.frame(occ, 1, 33 * i)
        assert [peak_tuple(p) for p in got.peaks] == want.peaks
        assert len(got.paths) == len(want.paths)
        for p, (cells, cost) in zip(got.paths, want.paths):
            assert [(c.row, c.col) for c in p.cells] == [tuple(x) for x in cells]
            assert p.total_cost == cost
        assert got.final_answer == want.answer
