"""The port's measurement tools (vision_assist_tpu_torch/tools/) on the CPU at
tiny counts: each ``main`` runs with ``--device cpu``, prints one JSON object
last with its keys and the device's stamp, writes only where ``--out``
points, and changes nothing under diagnostics/ (the JAX rounds' records).
The device-only tool's CPU counterpart of its CUDA graph (K chained calls of the
device program) equals K single calls, the exact_device angle cache
included. The graph capture itself needs the card (marked ``cuda``).
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from vision_assist_tpu_torch.tools import _card, diagnose_device_p50

REPO = pathlib.Path(__file__).resolve().parents[1]

# tool -> (tiny argv, keys its result must hold)
TOOLS = {
    "diagnose_device_p50": (["--frames", "2", "--trials", "1"], {"engines"}),
    "diagnose_h2d": (["--frames", "2", "--served", "3", "--depth", "2"],
                     {"bgr", "i420", "served_numpy_host_ms_per_frame",
                      "served_prefetch_host_ms_per_frame"}),
    "diagnose_engines": (["--sync", "2", "--pipe", "3", "--depth", "2",
                          "--streams", "2", "--steps", "1"], {"engines"}),
    "diagnose_fused": (["--reps", "2", "--depth", "2", "--streams", "2"],
                       {"program_sync_host_ms", "program_pipelined_host_ms",
                        "program_device_ms", "program_numpy_pipelined_host_ms",
                        "h2d_copy_device_ms", "d2h_payload_host_ms",
                        "streams2_sync_host_ms_per_frame"}),
    "diagnose_batch1": (["--reps", "1", "--depth", "2"],
                        {f"{s}_s{n}" for s in ("seg", "blur", "plan", "program")
                         for n in (1, 2)}),
    "diagnose_latency": (["--reps", "1", "--depth", "2"],
                         {"trivial", "h2d_1280x720", "segmenter_1280x720",
                          "plan_exact", "plan_wavefront_kernel", "d2h_payload"}),
    "diagnose_wire": (["--trials", "2", "--streams", "2", "--bench-fps", "20"],
                      {"upload_host_ms_per_batch", "ceiling_fps_i420",
                       "ceiling_fps_bgr", "bench_fps_single"}),
    "diagnose_detections": (["--frames", "2"], {"served_bf16", "cpu_float32",
                                                "frames_differing"}),
    "profile_pipeline": (["--frames", "2"], {"stages_host_ms", "frames_kept"}),
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


def test_device_p50_chained_calls_equal_single_calls(results):
    engines = results["diagnose_device_p50"][0]["engines"]
    assert set(engines) == set(diagnose_device_p50.ENGINES)
    for row in engines.values():
        assert row["payloads_equal_per_frame_calls"] is True
        assert row["frames"] == 2


@pytest.mark.parametrize("engine", diagnose_device_p50.ENGINES)
def test_chain_equals_single_calls_with_the_cache(engine):
    """The CPU counterpart of the graph: K chained calls of the program
    equal K calls one at a time, and exact_device's cache comes out of the
    chain as it does out of the single calls."""
    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.planning.device_astar import empty_cache

    seg = _card.flagship_segmenter(torch.device("cpu"))
    fp = FrameProcessor(_card.served_config(engine), segmenter=seg, device="cpu")
    fp._ensure_program()
    frames = _card.bench_frames(3)
    planes = torch.from_numpy(np.stack([bgr_to_i420_host(f) for f in frames]))
    cache0 = empty_cache("cpu") if engine == "exact_device" else None
    chained, cache = diagnose_device_p50._chain(fp._device_fn, planes, cache0)
    single = []
    for k in range(3):
        single.append(fp.submit_frame(frames[k]).payload())
    assert np.array_equal(chained.numpy(), np.stack(single))
    if engine == "exact_device":
        assert torch.equal(cache.view(torch.int32), fp._astar_cache.view(torch.int32))
        assert not torch.isnan(cache).all()


def test_upload_source_finds_uploads_only():
    src = diagnose_device_p50.HoistUploads._upload_source
    got = src(torch.tensor, ([1, 2],), {"device": "cuda", "dtype": torch.int32})
    assert torch.equal(got, torch.tensor([1, 2], dtype=torch.int32))
    assert src(torch.tensor, ([1, 2],), {}) is None
    x = torch.arange(3)
    assert torch.equal(src(torch.Tensor.to, (x, "cuda"), {}), x)
    assert torch.equal(src(torch.Tensor.to, (x,), {"device": torch.device("cuda")}), x)
    assert src(torch.Tensor.to, (x, torch.float32), {}) is None
    assert src(torch.Tensor.to, (x, "cpu"), {}) is None
    assert src(torch.add, (x, x), {}) is None


def test_out_under_diagnostics_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="diagnostics"):
        diagnose_device_p50.main(["--device", "cpu", "--frames", "1", "--out",
                                  str(REPO / "diagnostics" / "device_p50.json")])
    _card.check_out(tmp_path / "fine.json")


def test_cpu_stamp_and_percentiles():
    stamp = _card.card_stamp(torch.device("cpu"))
    assert stamp == {"device": "cpu", "nvidia_smi": None,
                     "device_clock": "host perf_counter (no card)"}
    assert _card.percentiles([1, 2, 3, 4], (50,)) == {"p50": 2.5}
    if torch.cuda.is_available():
        assert _card.require("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _card.require("cuda")


def test_compare_pathfinders_writes_pngs(tmp_path):
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.tools import compare_pathfinders

    with contextlib.redirect_stdout(io.StringIO()):
        assert compare_pathfinders.main(["--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    pngs = sorted(tmp_path.glob("*.png"))
    assert len(pngs) == 13
    img = read_png(pngs[0])
    assert img.shape == (64 * 20, 36 * 20, 3) and img.any()


def test_profile_pipeline_writes_the_timing_file(tmp_path):
    from vision_assist_tpu_torch.tools import profile_pipeline

    path = tmp_path / "timing_data.txt"
    with contextlib.redirect_stdout(io.StringIO()):
        assert profile_pipeline.main(["--device", "cpu", "--frames", "2",
                                      "--timing-data-path", str(path)]) == 0
    names = [line[:-1] for line in path.read_text().splitlines()
             if not line.startswith(" ")]
    assert names == list(profile_pipeline.STAGES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", diagnose_device_p50.ENGINES)
def test_graph_replay_equals_per_frame_calls(cuda, engine):
    seg = _card.flagship_segmenter(cuda)
    row = diagnose_device_p50.measure_engine(engine, seg, _card.bench_frames(2), 2, cuda)
    assert row["payloads_equal_per_frame_calls"] is True
    assert row["launches"] == {"relax": 2 if engine == "wavefront" else 0,
                               "astar": 2 if engine == "exact_device" else 0,
                               "sweep": 0}
