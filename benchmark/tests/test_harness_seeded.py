"""A configuration of a new architecture with seeded weights, added as new
files alone: its own reference module (here one that wraps
``reference/yolo.py``'s yolo11n-seg under another name), a configuration
that names it and gives ``"weights": {"seed": n}``, and a limits file. Its
model is judged at the head outputs (``head_gap``), what follows the model
(decode, NMS, masks, the lattice) from the program's own head outputs
(``conf_gap``, ``occ_share``, ``ndet_gap``), its planner as a trained
configuration's.

The test's configuration serves float32 at imgsz 128, so that a BatchNorm
variance off by 1 % stands well clear of the program's rounding: on this
CPU the sound program reads ``head_gap`` about 1e-5, each of the model's
BatchNorm variances scaled by 1.01 5e-4 to 1e-2, the float8 control about
1. At the served bf16 such a fault lies under the rounding (PERF.md). The
chain after the model reads 0 on all three numbers in a sound run; its
bfloat16 control reads ``conf_gap`` about 2e-4 and ``occ_share`` about
0.3 %; one lattice cell flipped a step reads ``occ_share`` about 0.013 %."""

import hashlib
import json
import time

import pytest
import torch
from conftest import CPU_SEED, ROOT, cpu_traffic, make_root

from benchmark.control import control_numbers
from benchmark.harness import runner
from benchmark.harness.cell import load_cell, reference_module
from benchmark.harness.check import SEEDED_NUMBERS, reference_segmentation
from benchmark.harness.frames import walkway_pool
from benchmark.harness.weights import flax_tree

NEW_REFERENCE = '''"""yolo11n-seg under another name: the reference of a configuration
that names this module."""

from benchmark.reference.yolo import (  # noqa: F401
    YoloSeg,
    flax_leaves,
    load_flax_variables,
    set_quant,
)


def build_model(config):
    return YoloSeg("yolo11n-seg", config["num_classes"], config["reg_max"],
                   config["num_mask_coeffs"])
'''

CELL = "wrapped11.cpu"
SEED = 2 ** 31 + 11          # a weights seed past 32 signed bits
LIMITS = {"head_gap": 1e-4, "conf_gap": 1e-5, "occ_share": 0.005, "ndet_gap": 0,
          "plan_frames": 0, "answer_frames": 0, "field_gap": 1e-5, "cost_gap": 1e-5,
          "state_gap": 0, "missing": 0}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def seeded_config(name="wrapped11-128", reference="wrapped11", dtype="float32"):
    config = json.loads((ROOT / "benchmark" / "configs" / "yolo11n-seg-256.json").read_text())
    config.update(name=name, imgsz=128, dtype=dtype, weights={"seed": SEED})
    if reference:
        config["reference"] = reference
    for key in ("published", "assumed"):
        config.pop(key)
    return config


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout to which only new files were added, with their digests
    before the additions."""
    root = make_root(tmp_path_factory.mktemp("seeded"))
    before = _digests(root)
    bench = root / "benchmark"
    (bench / "reference" / "wrapped11.py").write_text(NEW_REFERENCE)
    (bench / "configs" / "wrapped11-128.json").write_text(json.dumps(seeded_config()))
    (bench / "traffic" / "tiny.batch2.json").write_text(json.dumps(cpu_traffic("batched")))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "wrapped11-128", "source": "https://x.org",
                                "file": "benchmark/configs/wrapped11-128.json",
                                "reduced": [], "why": "a new architecture"})
    manifest["workloads"].append({"name": CELL, "config": "wrapped11-128",
                                  "traffic": "tiny.batch2", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root, before


def _run(root, faults=None):
    root, _ = root
    line, checks = runner.run_cell(root, CELL, CPU_SEED, 1.0, False, "cpu",
                                   time.perf_counter(), faults=faults)
    return line, {k: v for k, (v, _) in checks.items()}


def test_a_new_architecture_runs_from_new_files_alone(root, monkeypatch):
    root, before = root
    monkeypatch.setattr(runner, "TRACE_SECONDS", 0.5)
    line, checks = runner.run_cell(root, CELL, CPU_SEED, 1.0, True, "cpu",
                                   time.perf_counter())
    assert line["correct"], line["checks"]
    assert list(checks) == list(SEEDED_NUMBERS)
    assert line["failed"] == 0 and line["attempted"] >= 4
    assert "setup_s" not in line["metrics"]     # a traced run reports the per-layer ones
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_one_served_batchnorm_variance_off_by_one_percent_fails(root):
    def scaled(loop):
        bn = next(m for m in loop.segmenter.model.modules()
                  if isinstance(m, torch.nn.BatchNorm2d))
        bn.running_var.mul_(1.01)

    line, numbers = _run(root, scaled)
    assert not line["correct"]
    assert numbers["head_gap"] > LIMITS["head_gap"], numbers


def flip_a_cell(result):
    """One lattice cell of the step's first frame flipped."""
    result.occupancy[0, 10, 5] = ~result.occupancy[0, 10, 5]


def drop_a_detection(result):
    """The step's first frame's first kept detection dropped."""
    valid = result.detections.valid
    valid[0, int(torch.nonzero(valid[0])[0])] = False


@pytest.mark.parametrize("alter, number", [(flip_a_cell, "occ_share"),
                                           (drop_a_detection, "ndet_gap")])
def test_a_segmentation_altered_where_it_is_produced_fails(root, alter, number):
    """The fault lands in the timed path's own segmenter call, after the
    model: the served module's heads are sound, what follows them is not."""
    def altered(loop):
        chain = loop.segmenter._frame_chain

        def wrong(frames):
            result = chain(frames)
            alter(result)
            return result
        loop.segmenter._frame_chain = wrong

    line, numbers = _run(root, altered)
    assert not line["correct"]
    assert numbers["head_gap"] <= LIMITS["head_gap"], numbers
    assert numbers[number] > LIMITS[number], numbers


@pytest.fixture(scope="module")
def control(root):
    root, _ = root
    return control_numbers(root, load_cell(root, CELL), CPU_SEED, torch.device("cpu"))


def test_the_float8_control_fails_head_gap(control):
    assert control["head_gap"] > 100 * LIMITS["head_gap"], control


def test_the_bfloat16_chain_after_the_model_fails(control):
    assert control["conf_gap"] > 10 * LIMITS["conf_gap"], control
    assert control["occ_share"] > 10 * LIMITS["occ_share"], control


def test_the_ports_converted_weights_are_the_references_cast():
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models.inference import Segmenter

    config = seeded_config(reference=None, dtype="bfloat16")
    tree = flax_tree(ROOT, config, "cpu")
    ref = reference_module(ROOT, config).build_model(config)
    reference_module(ROOT, config).load_flax_variables(ref, tree)
    want = ref.state_dict()
    seg = Segmenter(ModelConfig(arch=config["arch"], imgsz=config["imgsz"], dtype="bfloat16"),
                    variables=tree, example_hw=(1280, 720), device="cpu")
    got = {k: v for k, v in seg.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == {k for k in want if not k.endswith("num_batches_tracked")}
    assert {v.dtype for v in got.values()} == {torch.bfloat16, torch.float32}
    for k, v in got.items():
        assert torch.equal(v, want[k].to(v.dtype)), k


@pytest.mark.parametrize("arch", ["yolo11n-seg", "yolov8n-seg"])
def test_the_seeded_head_outputs_keep_their_size(arch):
    config = dict(seeded_config(reference=None), arch=arch)
    seg = reference_segmentation(ROOT, config, flax_tree(ROOT, config, "cpu"),
                                 walkway_pool(2, 1280, 720, seed=CPU_SEED),
                                 torch.device("cpu"), heads=True)
    for out in seg:
        for head in out.heads:
            rms = float(torch.sqrt(torch.mean(head.double() ** 2)))
            assert 0.05 <= rms <= 20, (arch, rms)


def test_the_same_seed_draws_the_same_weights():
    config = seeded_config(reference=None)
    a, b = flax_tree(ROOT, config, "cpu"), flax_tree(ROOT, config, "cpu")
    c = flax_tree(ROOT, dict(config, weights={"seed": SEED + 1}), "cpu")
    kernel = ("params", "ConvBNAct_0", "Conv_0", "kernel")

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    assert (leaf(a, kernel) == leaf(b, kernel)).all()
    assert not (leaf(a, kernel) == leaf(c, kernel)).all()
    var = leaf(a, ("batch_stats", "ConvBNAct_0", "BatchNorm_0", "var"))
    assert var.min() > 0
