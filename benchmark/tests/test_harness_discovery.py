"""A configuration, a traffic mix, a serving loop, a cell and a per-layer
metric added as new files and new entries are found by name: no file the
benchmark already has is edited."""

import hashlib
import json
import time

from conftest import CPU_SEED, cpu_traffic, make_root

from benchmark.harness import runner
from benchmark.harness.cell import load_cell, metric_reader

NEW_METRIC = '''"""Frames the window answered."""


def read(run):
    return float(run.frames_done)
'''


NEW_LOOP = '''"""One camera through the port's FrameProcessor.__call__."""

import time

from benchmark.harness.serve import Loop as _Loop


class Loop(_Loop):
    def build(self, cfg, device):
        from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

        return FrameProcessor(cfg, segmenter=self.segmenter, device=device)

    def serve(self, seconds):
        t_begin = time.perf_counter()
        while True:
            seq = self.seq
            self.attempted += 1
            t0 = time.perf_counter()
            result = self.processor(self.pool[self.pool_index(0, seq)],
                                    now_ms=seq * self.interval)
            t1 = time.perf_counter()
            self.seq += 1
            self.frame_ms.append((t1 - t0) * 1e3)
            self.keep(result, 0, seq)
            if t1 - t_begin >= seconds:
                return t1 - t_begin
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    before = _digests(root)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "yolov8n-seg-640.json").read_text())
    config.update(name="yolov8n-seg-640-bgr", transfer_format="bgr")
    (bench / "configs" / "yolov8n-seg-640-bgr.json").write_text(json.dumps(config))
    traffic = dict(cpu_traffic("sync"), serving="called")
    (bench / "traffic" / "tiny.sync.json").write_text(json.dumps(traffic))
    (bench / "loops" / "called.py").write_text(NEW_LOOP)
    limits = json.loads((bench / "limits" / "v8n640.cam720.sync.json").read_text())
    (bench / "limits" / "v8n640bgr.tiny.json").write_text(json.dumps(limits))
    (bench / "metrics" / "frames_answered.sync.py").write_text(NEW_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "yolov8n-seg-640-bgr", "source": "https://x.org",
                                "file": "benchmark/configs/yolov8n-seg-640-bgr.json",
                                "reduced": [], "why": "frames sent as BGR"})
    manifest["workloads"].append({"name": "v8n640bgr.tiny", "config": "yolov8n-seg-640-bgr",
                                  "traffic": "tiny.sync", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "frames_answered.sync", "unit": "frames",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "serving loop", "moves": "latency_p50_ms",
                                  "workloads": ["v8n640bgr.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = load_cell(root, "v8n640bgr.tiny")
    assert cell.config["transfer_format"] == "bgr"
    assert cell.traffic["pool"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "frames_answered.sync"
    assert metric_reader(root, "frames_answered.sync") is not None

    monkeypatch.setattr(runner, "TRACE_SECONDS", 0.5)
    line, _ = runner.run_cell(root, "v8n640bgr.tiny", CPU_SEED, 0.5, True, "cpu",
                              time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_answered.sync"]["value"] >= 1
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_module_is_run_once_a_process(tmp_path):
    """Each later lookup of one file gets the module its first run made (one
    reference model class a run); another checkout's file is its own."""
    from benchmark.harness.cell import reference_module

    first, second = make_root(tmp_path / "a"), make_root(tmp_path / "b")
    module = reference_module(first, {})
    assert reference_module(first, {"reference": "yolo"}) is module
    assert reference_module(second, {}) is not module
    assert reference_module(second, {}).YoloSeg is not module.YoloSeg
