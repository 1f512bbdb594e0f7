"""Concatenations made in place in the segmenter (``models/yolo.py``).

In eval mode outside autograd, on channels_last activations, no block calls
``torch.cat``: each allocates its concatenation buffer and every piece's
producer stores into its slice (``bn_act_into``, ``torch.add(..., out=)``, the
neck's upsample as a strided copy). On the CPU:

* every block with a concatenation, and whole forwards of yolo11n-seg,
  yolov8n-seg and yolo12n-seg (every head output), are bit-equal to the
  ``torch.cat`` composition the port ran before, written out here;
* ``cat_copies`` counts what is still concatenated or copied: 1 a forward of
  yolo11n-seg (SPPF's cat), 6 of YOLO12x-seg (the three ABlock unit results
  of each backbone A2C2f that the next unit reads too), every cat in train
  mode, on NCHW activations and under autograd; ``view_stores`` the epilogues
  stored into a slice;
* train mode is unchanged, gradients included.
"""

from __future__ import annotations

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.ops import cuda_bn_act

torch.set_num_threads(2)


def _cat_composition(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``m``'s forward as the port ran it before, each concatenation a
    ``torch.cat`` of the pieces as separate tensors."""
    def run(child, z):
        return _cat_composition(child, z)

    if isinstance(m, yolo.ConvBNAct):
        return m(x)
    if isinstance(m, nn.Sequential):
        for layer in m:
            x = run(layer, x)
        return x
    if isinstance(m, yolo.Bottleneck):
        y = m.cv2(m.cv1(x))
        return x + y if m.add else y
    if isinstance(m, (yolo.C2f, yolo.C3k2)):
        outs = list(torch.chunk(m.cv1(x), 2, dim=1))
        for unit in m.m:
            outs.append(run(unit, outs[-1]))
        return m.cv2(torch.cat(outs, dim=1))
    if isinstance(m, yolo.C3):
        a = m.cv1(x)
        for unit in m.m:
            a = run(unit, a)
        return m.cv3(torch.cat([a, m.cv2(x)], dim=1))
    if isinstance(m, yolo.SPPF):
        ys = [m.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], m.pool, stride=1, padding=m.pool // 2))
        return m.cv2(torch.cat(ys, dim=1))
    if isinstance(m, yolo.PSABlock):
        x = x + m.attn(x)
        return x + m.ffn2(m.ffn1(x))
    if isinstance(m, yolo.C2PSA):
        a, b = torch.chunk(m.cv1(x), 2, dim=1)
        for unit in m.m:
            b = run(unit, b)
        return m.cv2(torch.cat([a, b], dim=1))
    if isinstance(m, yolo.ABlock):
        x = x + m.attn(x)
        return x + m.mlp(x)
    if isinstance(m, yolo.A2C2f):
        ys = [m.cv1(x)]
        for unit in m.m:
            ys.append(run(unit, ys[-1]))
        y = m.cv2(torch.cat(ys, dim=1))
        return y if m.gamma is None else x + m.gamma.to(y.dtype).view(1, -1, 1, 1) * y
    raise TypeError(type(m))


def _forward_by_cat(model: yolo.YoloSeg, images: torch.Tensor) -> yolo.YoloSegOutputs:
    """``YoloSeg.forward`` as the port ran it before: the neck's four
    ``torch.cat`` of ``F.interpolate``'s upsample and the levels."""
    x = images.to(model.dtype)
    for i, layer in enumerate(model.backbone):
        x = _cat_composition(layer, x)
        if i == model._p3_at:
            p3 = x
        elif i == model._p4_at:
            p4 = x
    p5 = x

    def up(z):
        return F.interpolate(z, scale_factor=2, mode="nearest")

    h1 = _cat_composition(model.h1, torch.cat([up(p5), p4], dim=1))
    n3 = _cat_composition(model.n3, torch.cat([up(h1), p3], dim=1))
    n4 = _cat_composition(model.n4, torch.cat([model.d1(n3), h1], dim=1))
    n5 = _cat_composition(model.n5, torch.cat([model.d2(n4), p5], dim=1))
    branches: list[list[torch.Tensor]] = [[], [], []]
    for f, head in zip([n3, n4, n5], model.heads):
        for out, branch in zip(branches, head):
            y = f
            for layer in branch[:-1]:
                y = layer(y)
            out.append(branch[-1](y.float()))
    return yolo.YoloSegOutputs(box_logits=branches[0], cls_logits=branches[1],
                               coeffs=branches[2], protos=model.proto(n3).float(),
                               strides=(8, 16, 32))


def _outputs(o: yolo.YoloSegOutputs) -> list[torch.Tensor]:
    return [*o.box_logits, *o.cls_logits, *o.coeffs, o.protos]


def _spread_statistics(model: nn.Module, seed: int) -> nn.Module:
    """Running statistics and affine parameters off their initial values, so
    every epilogue does arithmetic."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, nn.BatchNorm2d):
                c = bn.num_features
                bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
                bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
                bn.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
        for m in model.modules():
            if isinstance(m, yolo.A2C2f) and m.gamma is not None:
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=g) + 0.5)
    return model


def _images(batch: int, c: int, size: int, seed: int = 0) -> torch.Tensor:
    """bf16 activations laid out as the served frames are: channels_last."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(batch, size, size, c, generator=g).to(torch.bfloat16)
    return x.permute(0, 3, 1, 2)


BLOCKS = {
    "C2f": lambda: yolo.C2f(32, 64, 2, shortcut=True),
    "C2f-no-shortcut": lambda: yolo.C2f(64, 32, 2, shortcut=False),
    "C3": lambda: yolo.C3(32, 64, 2),
    "C3k2-c3k": lambda: yolo.C3k2(32, 64, 2, c3k=True),
    "C3k2-bottleneck": lambda: yolo.C3k2(32, 64, 2, c3k=False, expansion=0.25),
    "SPPF": lambda: yolo.SPPF(64, 64),
    "C2PSA": lambda: yolo.C2PSA(128, 128, 2),
    "A2C2f-a2": lambda: yolo.A2C2f(64, 64, 2, a2=True, area=4),
    "A2C2f-a2-residual": lambda: yolo.A2C2f(64, 64, 2, a2=True, area=1, residual=True,
                                            mlp_ratio=1.2),
    "A2C2f-c3k": lambda: yolo.A2C2f(96, 64, 2, a2=False),
}
# What each block, alone, still concatenates or copies (SPPF its cat; a unit
# of a C2f, C3k2 or A2C2f whose result ends in a residual sum that the next
# unit reads as well, a copy each) and how many of its epilogues store into a
# slice (cv1, and each inner C3's cv2, and a C3 unit's cv3 where the buffer
# takes its result).
IN_PLACE = {"C2f": (1, 1), "C2f-no-shortcut": (0, 3), "C3": (0, 1), "C3k2-c3k": (0, 5),
            "C3k2-bottleneck": (1, 1), "SPPF": (1, 0), "C2PSA": (0, 1), "A2C2f-a2": (1, 1),
            "A2C2f-a2-residual": (1, 1), "A2C2f-c3k": (0, 5)}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_eval_block_bit_equal_to_its_cat_composition(name):
    torch.manual_seed(len(name))
    block = _spread_statistics(BLOCKS[name](), len(name)).eval()
    c_in = next(m for m in block.modules() if isinstance(m, yolo.ConvBNAct)).conv.in_channels
    x = _images(2, c_in, 8)
    with torch.no_grad():
        want = _cat_composition(block, x)
        yolo.reset_cat_copies()
        cuda_bn_act.reset_launches()
        got = block(x)
    assert torch.equal(got, want)
    assert (yolo.cat_copies, cuda_bn_act.view_stores) == IN_PLACE[name]


@pytest.mark.parametrize("name", ["C3k2-c3k", "A2C2f-a2-residual"])
def test_eval_block_stores_its_result_into_the_callers_slice(name):
    """A block handed ``out`` (and ``also``) stores its result there, as
    YoloSeg's neck hands the backbone's levels their buffers."""
    torch.manual_seed(1)
    block = _spread_statistics(BLOCKS[name](), 1).eval()
    c_in = next(m for m in block.modules() if isinstance(m, yolo.ConvBNAct)).conv.in_channels
    x = _images(2, c_in, 8)
    buf = torch.full((2, 96, 8, 8), float("nan"), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    also = torch.empty((2, 64, 8, 8), dtype=torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        want = _cat_composition(block, x)
        block(x, out=buf.narrow(1, 32, 64), also=also)
    assert torch.equal(buf[:, 32:], want) and torch.equal(also, want)
    assert bool(buf[:, :32].isnan().all())


# (arch, imgsz, batch, cat_copies in eval mode in place, view stores, cats in train mode)
FORWARDS = [("yolo11n-seg", 256, 2, 1, 21, 17), ("yolov8n-seg", 128, 2, 3, 18, 13),
            ("yolo12n-seg", 128, 2, 2, 22, 16)]


@pytest.mark.parametrize("arch,imgsz,batch,copies,stores,cats", FORWARDS)
def test_eval_forward_bit_equal_to_the_cat_forward(arch, imgsz, batch, copies, stores, cats):
    torch.manual_seed(0)
    model = _spread_statistics(yolo.YoloSeg(arch), 0).eval()
    images = _images(batch, 3, imgsz, seed=1)
    with torch.no_grad():
        want = _outputs(_forward_by_cat(model, images))
        yolo.reset_cat_copies()
        cuda_bn_act.reset_launches()
        got = _outputs(model(images))
    assert yolo.cat_copies == copies
    assert cuda_bn_act.view_stores == stores
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_yolo12x_forward_copies_six_pieces():
    """YOLO12x-seg at imgsz 64: 24 concatenations in train mode; in place,
    only the three ABlock unit results of each backbone A2C2f (four units,
    each read by the next) are copied into their slices. Its P4, a residual
    sum that the stride-2 convolution after it pads with a copy, is stored
    into the neck's buffer alone."""
    torch.manual_seed(0)
    model = yolo.YoloSeg("yolo12x-seg").eval()
    images = _images(1, 3, 64)
    with torch.no_grad():
        yolo.reset_cat_copies()
        cuda_bn_act.reset_launches()
        got = _outputs(model(images))
        assert (yolo.cat_copies, cuda_bn_act.view_stores) == (6, 36)
        yolo.reset_cat_copies()
        want = _outputs(_forward_by_cat(model, images))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    yolo.reset_cat_copies()
    with torch.no_grad():
        model.train()(images)
    assert yolo.cat_copies == 24


@pytest.mark.parametrize("case", ["nchw", "autograd", "train"])
def test_the_cat_path_where_pieces_cannot_be_stored_in_place(case):
    """NCHW activations (no kernel stores into an NCHW slice), autograd (an
    ``out=`` store has no gradient) and train mode concatenate: every one of
    yolo11n-seg's 17 cats, no view store."""
    torch.manual_seed(0)
    model = yolo.YoloSeg("yolo11n-seg").train(case == "train")
    images = _images(2, 3, 64)
    if case == "nchw":
        images = images.contiguous()
    yolo.reset_cat_copies()
    cuda_bn_act.reset_launches()
    with torch.set_grad_enabled(case == "autograd"):
        model(images)
    assert yolo.cat_copies == 17
    assert cuda_bn_act.view_stores == 0


@pytest.mark.parametrize("arch", ["yolo11n-seg", "yolo12n-seg"])
def test_train_mode_unchanged_gradients_included(arch):
    """Train mode (float32 weights, Flax's batch statistics) against the
    cat composition: outputs, every parameter's gradient and the running
    statistics bit-equal."""
    torch.manual_seed(2)
    model = yolo.YoloSeg(arch, param_dtype=torch.float32).train()
    twin = copy.deepcopy(model)
    images = _images(2, 3, 64, seed=3)
    got, want = _outputs(model(images)), _outputs(_forward_by_cat(twin, images))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sum(t.float().square().mean() for t in got).backward()
    sum(t.float().square().mean() for t in want).backward()
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(model.named_buffers(), twin.buffers()):
        assert torch.equal(b, c), name


@pytest.mark.parametrize("case", ["train-out", "train-also", "also-alone", "sum-also-alone"])
def test_a_store_without_its_view_raises(case):
    """``out`` is a store of eval mode and ``also`` one beside ``out``: a
    block handed them otherwise raises, and leaves no slice unwritten."""
    torch.manual_seed(0)
    x = _images(2, 16, 8)
    buf = torch.empty((2, 32, 8, 8), dtype=torch.bfloat16, memory_format=torch.channels_last)
    out, also = buf.narrow(1, 16, 16), torch.empty_like(buf.narrow(1, 0, 16))
    if case == "sum-also-alone":            # the residual sum of a Bottleneck
        block, kwargs = yolo.Bottleneck(16, 16).eval(), {"also": also}
    else:
        block = yolo.ConvBNAct(16, 16, 3).train(case.startswith("train"))
        kwargs = {"train-out": {"out": out}, "train-also": {"out": out, "also": also},
                  "also-alone": {"also": also}}[case]
    with torch.no_grad(), pytest.raises(ValueError, match="also"):
        block(x, **kwargs)
