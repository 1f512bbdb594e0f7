"""The FLOP count behind the mfu metrics, against a hand count."""

import json

import pytest
from conftest import ROOT
from torch import nn

from benchmark.harness.cell import reference_module
from benchmark.harness.peaks import anchors_at, astar_bound_s, model_flops, nms_counts
from benchmark.reference.yolo import YoloSeg


def test_conv_stack_counts_two_flops_a_multiply_add():
    model = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=2, padding=1, bias=False),     # 32x32 -> 16x16
        nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False),     # depthwise
        nn.ConvTranspose2d(8, 4, 2, stride=2),                   # 16x16 -> 32x32
        nn.Conv2d(4, 2, 1))
    macs = (16 * 16 * 8 * 3 * 9          # stride-2 conv: each output 3*9 taps
            + 16 * 16 * 8 * 9            # depthwise: 9 taps an output
            + 16 * 16 * 8 * 4 * 4        # transposed: each input feeds 4 outputs x 4 ch
            + 32 * 32 * 2 * 4)           # 1x1
    assert model_flops(model, 32) == 2 * macs


def test_the_reference_models_sit_near_their_published_counts():
    # Published at 640 with 80 classes: 10.4 GFLOPs (YOLO11n-seg) and 12.6
    # (YOLOv8n-seg); one class and the same trunk count a little less.
    y11 = model_flops(YoloSeg("yolo11n-seg"), 640)
    v8 = model_flops(YoloSeg("yolov8n-seg"), 640)
    assert 0.8 * 10.4e9 < y11 < 1.05 * 10.4e9
    assert 0.8 * 12.6e9 < v8 < 1.05 * 12.6e9
    assert model_flops(YoloSeg("yolo11n-seg"), 256) < y11 * (256 / 640) ** 2 * 1.05


@pytest.mark.parametrize("name, flops", [("yolo11n-seg-256", 1_532_493_824),
                                         ("yolov8n-seg-640", 11_340_441_600)])
def test_the_flops_through_the_reference_lookup_are_unchanged(name, flops):
    # The counts the configurations read before a configuration named its
    # reference module: the reference built by arch name.
    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    built = reference_module(ROOT, c).build_model(c)
    assert model_flops(built, c["imgsz"]) == flops
    by_name = YoloSeg(c["arch"], c["num_classes"], c["reg_max"], c["num_mask_coeffs"])
    assert model_flops(by_name, c["imgsz"]) == flops


def test_kernel_counts():
    assert anchors_at(256) == 32 * 32 + 16 * 16 + 8 * 8
    assert anchors_at(640) == 8400
    n_bytes, n_ops = nms_counts(1344, [9], [1])
    assert n_ops == 14 * 36 + 8 * 9 + 1344
    assert n_bytes == 1344 * 4 + 9 * 24 + 32 * 4 + 32 * (16 + 4 + 4 + 128 + 1)
    assert astar_bound_s(8, 2304, 8, 512) == 8 * (5 * 2304 + 8 + 72 + 4904 + 32768
                                                   + 128 + 4904) / 3.35e12
