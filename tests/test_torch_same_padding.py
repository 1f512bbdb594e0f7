"""SAME padding inside the segmenter's convolutions (``models/yolo.py``).

In eval mode ``ConvBNAct`` passes its SAME pads to the convolution as its own
``padding`` wherever they are symmetric on both axes, and pads explicitly only
where they are not (a stride-2 convolution on an even size); train mode pads
explicitly. On the CPU:

* The block is bit-equal to the explicit composition, ``F.conv2d`` of
  ``_pad_same(x, k, s)`` with no padding followed by the block's epilogue, in
  eval mode (``bn_act``) and in train mode (Flax's batch statistics, float32
  weights cast to bf16), gradients included: every kernel size, stride,
  group count and parity of H and W the models use, at 8 channels. (At some
  larger bf16 shapes oneDNN blocks the two calls apart, and about one output
  in 10^4 differs by one bf16 ulp: 64 channels at 64x64.)
* ``pad_copies`` counts the explicit pads: 7 a forward of either served
  configuration (its stride-2 convolutions), none for a symmetric pad in eval
  mode, one for every padded convolution in train mode.
"""

from __future__ import annotations

import copy
import itertools

import pytest
import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act

torch.set_num_threads(2)

C = 8
CASES = list(itertools.product((1, 3, 7), (1, 2), (8, 9), (10, 11), (1, 2, C),
                               ("eval", "train")))


def _composed(block: yolo.ConvBNAct, x: torch.Tensor) -> torch.Tensor:
    """The block's forward with the pad made explicitly, as it was before the
    convolution took it."""
    conv, bn = block.conv, block.bn
    y = F.conv2d(yolo._pad_same(x, block.kernel, block.stride),
                 conv.weight.to(block.dtype), None, block.stride, 0, 1,
                 conv.groups)
    if not block.training:
        return bn_act(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                      bn.eps, block.act)
    return F.silu(yolo._flax_batch_norm_train(y.float(), bn)).to(block.dtype)


@pytest.mark.parametrize("k,s,h,w,groups,mode", CASES)
def test_block_equals_the_explicitly_padded_composition(k, s, h, w, groups, mode):
    torch.manual_seed(k * 100 + s * 10 + groups)
    block = yolo.ConvBNAct(C, C, k, s, groups=groups)
    with torch.no_grad():
        block.bn.weight.uniform_(0.5, 1.5)
        block.bn.bias.normal_()
        block.bn.running_mean.normal_()
        block.bn.running_var.uniform_(0.5, 2.0)
    if mode == "train":
        block.conv.to(torch.float32)        # training's param_dtype
    block.train(mode == "train")
    twin = copy.deepcopy(block)
    x = torch.randn(2, C, h, w).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()

    got, want = block(xa), _composed(twin, xb)
    assert torch.equal(got, want)
    if mode == "train":
        grad = torch.randn_like(got)
        got.backward(grad)
        want.backward(grad)
        assert torch.equal(xa.grad, xb.grad)
        assert torch.equal(block.conv.weight.grad, twin.conv.weight.grad)
        assert torch.equal(block.bn.running_mean, twin.bn.running_mean)
        assert torch.equal(block.bn.running_var, twin.bn.running_var)


@pytest.mark.parametrize("arch,imgsz", [("yolo11n-seg", 256), ("yolo12x-seg", 64)])
def test_a_served_forward_pads_only_its_stride2_convolutions(arch, imgsz):
    torch.manual_seed(0)
    model = yolo.YoloSeg(arch).eval()
    x = torch.rand(1, 3, imgsz, imgsz).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    strided = sum(isinstance(m, yolo.ConvBNAct) and m.stride == 2
                  for m in model.modules())
    yolo.reset_pad_copies()
    with torch.no_grad():
        model(x)
    assert yolo.pad_copies == strided == 7


@pytest.mark.parametrize("k,s,size,mode,copies", [
    (3, 1, 16, "eval", 0),      # stride 1: (1, 1)
    (7, 1, 16, "eval", 0),      # the depthwise pe: (3, 3)
    (3, 2, 15, "eval", 0),      # stride 2 on an odd size: (1, 1)
    (3, 2, 16, "eval", 1),      # stride 2 on an even size: (0, 1)
    (1, 1, 16, "train", 0),     # nothing to pad
    (3, 1, 16, "train", 1),
])
def test_only_an_asymmetric_pad_is_copied_in_eval_mode(k, s, size, mode, copies):
    block = yolo.ConvBNAct(4, 4, k, s).train(mode == "train")
    yolo.reset_pad_copies()
    with torch.no_grad():
        block(torch.rand(2, 4, size, size).to(torch.bfloat16))
    assert yolo.pad_copies == copies
