"""The SegFormer-B5 configuration as the harness reads it: its cell and
files, the port's ``ModelConfig`` it gives, the reference module's contract
(it imports neither the JAX stack nor the port when it runs, and its
forward runs on the meta device), and the seeded draw of its tree at a
small imgsz."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark.harness import weights
from benchmark.harness.cell import load_cell, reference_module
from benchmark.harness.serve import model_config

CELL = "sfb5_1024.cam720.batch8"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "segformer-b5-1024.json").read_text())
NEW_METRICS = ["mfu.sfb5_1024", "esa_roofline.sfb5_1024", "esa_card_share.sfb5_1024",
               "esa_issue_ms.sfb5_1024"]


def test_the_cell_and_its_files():
    cell = load_cell(ROOT, CELL)
    assert cell.config == CONFIG and cell.chips == 1
    assert cell.traffic == json.loads(
        (ROOT / "benchmark" / "traffic" / "cam720.batch8.json").read_text())
    assert [m["name"] for m in cell.per_layer] == NEW_METRICS
    assert [m["name"] for m in cell.end_to_end] == ["card_ms_per_frame", "setup_s"]
    assert set(cell.limits) == {"head_gap", "conf_gap", "occ_share", "ndet_gap", "plan_frames",
                                "answer_frames", "field_gap", "cost_gap", "state_gap",
                                "missing"}


def test_the_port_gets_a_per_pixel_head():
    from vision_assist_tpu_torch.config import ModelConfig

    assert model_config(CONFIG) == ModelConfig(
        arch="segformer-b5", num_classes=19, walkable_classes=(1,), imgsz=1024,
        dtype="bfloat16")


def test_the_reference_imports_neither_the_jax_stack_nor_the_port():
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.reference import segformer as s;"
            "m = s.build_model({'arch': 'segformer-b5', 'num_classes': 19}).to('meta');"
            "out = m(torch.zeros(1, 3, 64, 64, device='meta'));"
            "assert out.logits.shape == (1, 19, 16, 16), out.logits.shape;"
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "vision_assist_tpu",
                         "vision_assist_tpu_torch"}


@pytest.fixture(scope="module")
def tree():
    """SegFormer-B5's tree at every published width, drawn at imgsz 64."""
    return weights.draw(reference_module(ROOT, CONFIG), dict(CONFIG, imgsz=64),
                        CONFIG["weights"]["seed"], torch.device("cpu"))


def test_the_seeded_tree_is_finite_and_drawn_by_layout(tree):
    params = tree["params"]
    leaves = [np.asarray(v) for p in params.values() for v in p.values()]
    leaves += [np.asarray(v) for p in tree["batch_stats"].values() for v in p.values()]
    assert all(np.isfinite(v).all() for v in leaves)
    assert sum(v.size for v in leaves) == 84_607_955 + 2 * 768      # the running statistics
    q = params["segformer.encoder.block.2.17.attention.self.query"]["kernel"]
    assert q.shape == (320, 320)
    assert float(np.std(q)) == pytest.approx(1 / math.sqrt(320), rel=0.02)
    sr = params["segformer.encoder.block.0.1.attention.self.sr"]["kernel"]
    assert sr.shape == (8, 8, 64, 64)                       # HWIO
    ln = params["segformer.encoder.block.2.17.layer_norm_1"]["scale"]
    assert 0.5 <= ln.min() and ln.max() <= 1.5
    bn = params["decode_head.batch_norm"]["scale"]
    assert weights.SCALE[0] <= bn.min() and bn.max() <= weights.SCALE[1]
    assert tree["batch_stats"]["decode_head.batch_norm"]["var"].min() > 0
