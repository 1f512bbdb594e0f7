"""YOLOv9e-seg in the port (``models/yolo.py``) against the benchmark's plain
reference (``benchmark/reference/yolov9.py``), and its fused CBFuse
(``ops/cuda_cb_fuse.py``), on the CPU.

The JAX package has no YOLOv9, so the reference is the float32 model written
from the paper and Ultralytics' yaml, and the weights are the benchmark's
seeded draw (``benchmark/harness/weights.py::draw``, BatchNorm statistics
calibrated on walkway frames at the test's imgsz), loaded into both through
their Flax bridges.

* The four head outputs, as the benchmark's ``head_gap`` measures them (the
  largest |port - reference| over the reference's RMS, each output and
  frame), on two walkway frames: float32 within 1e-4 (the port folds each
  RepConv's two branches into one convolution, and the two sum their
  convolutions in another order; readings ~2e-5); bf16 within 0.4, the
  seeded YOLO12x cell's limit (bf16 keeps 8 bits of each activation and weight through
  some 300 layers; readings ~0.1, where the reference with float8 operands,
  the benchmark's control, reads above 1).
* The parameter count at 80 classes (the published 60.5 M) and the FLOPs of
  the reference at 640 that the benchmark's ``mfu`` reader divides by.
* A folded RepConv against its two branches; one convolution a RepConv in
  eval mode, two in train mode; the fold made again after a load.
* ``cb_fuse``'s plain twin against Ultralytics' interpolate-and-sum, the
  operator on the CPU the twin, reading slices of a CBLinear's output; its
  checks; on fake CUDA tensors, five ``cb_fuse`` operators a forward and no
  upsample.
* In eval mode the concatenations in place, bit-equal to the ``torch.cat``
  path; ``cat_copies`` 1 a forward (SPPELAN's).
* The bridge names every leaf as the reference does and takes each once.
* ``ModelConfig(arch="yolov9e-seg")`` through ``Segmenter``,
  ``MultiStreamProcessor`` and ``BatchedStreamingServer``.

On a card (marked ``cuda``): the kernel bit for bit its twin at the five
fusions' shapes at imgsz 640 and batch 8, bf16 and float32; its scalar form;
five launches a served forward. This file imports no JAX.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness.check import head_gap
from benchmark.harness.frames import walkway_pool
from benchmark.harness.peaks import model_flops
from benchmark.harness.weights import draw
from benchmark.reference import yolov9 as ref9
from benchmark.reference.segment import ExactFloat32
from vision_assist_tpu_torch import config
from vision_assist_tpu_torch.io.synthetic import walkway_frames
from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.models.inference import Segmenter
from vision_assist_tpu_torch.models.yolo import (
    ARCHS,
    CB_WIDTHS,
    RepConv,
    YoloSeg,
    convert_flax_variables,
    flax_leaves,
    to_flax_variables,
)
from vision_assist_tpu_torch.ops import cuda_bn_act, cuda_cb_fuse
from vision_assist_tpu_torch.ops.cuda_cb_fuse import cb_fuse, cb_fuse_plain
from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor
from vision_assist_tpu_torch.pipeline.server import BatchedStreamingServer

torch.set_num_threads(2)

ARCH = "yolov9e-seg"
SEED = 2 ** 31 + 25
F32_LIMIT = 1e-4
BF16_LIMIT = 0.4
_trees: dict = {}


def _config(imgsz: int) -> dict:
    return {"arch": ARCH, "imgsz": imgsz, "num_classes": 1, "reg_max": 16,
            "num_mask_coeffs": 32}


def _tree(imgsz: int) -> dict:
    if imgsz not in _trees:
        _trees[imgsz] = draw(ref9, _config(imgsz), SEED, "cpu")
    return _trees[imgsz]


def _model(imgsz: int, dtype=torch.float32) -> YoloSeg:
    model = YoloSeg(ARCH, dtype=dtype)
    model.load_state_dict(convert_flax_variables(_tree(imgsz), model))
    return model.eval()


def _images(imgsz: int) -> torch.Tensor:
    frames = walkway_pool(2, imgsz, imgsz, seed=imgsz)
    return torch.from_numpy(frames[..., ::-1].copy()).permute(0, 3, 1, 2).float() / 255.0


def _flat(out) -> list[list[torch.Tensor]]:
    """Each frame's four head outputs, flattened as the benchmark's check does."""
    heads = [torch.cat([t.flatten(2) for t in getattr(out, h)], 2).float()
             for h in ("box_logits", "cls_logits", "coeffs")] + [out.protos.float()]
    return [[h[i] for h in heads] for i in range(heads[0].shape[0])]


def _outputs(o) -> list[torch.Tensor]:
    return [*o.box_logits, *o.cls_logits, *o.coeffs, o.protos]


@pytest.mark.parametrize("imgsz,dtype,limit", [
    (64, torch.float32, F32_LIMIT), (128, torch.float32, F32_LIMIT),
    (64, torch.bfloat16, BF16_LIMIT), (128, torch.bfloat16, BF16_LIMIT)])
def test_port_equals_the_reference(imgsz, dtype, limit):
    ref = ref9.build_model(_config(imgsz))
    ref9.load_flax_variables(ref, _tree(imgsz))
    model = _model(imgsz, dtype)
    images = _images(imgsz)
    with torch.no_grad(), ExactFloat32():
        want = ref.eval()(images)
        got = model(images)
    gap = head_gap(_flat(got), _flat(want))
    assert gap <= limit, gap
    assert all(torch.isfinite(t).all() for frame in _flat(got) for t in frame)


def test_parameters_against_the_published_count():
    """At 80 classes the port and the reference hold 60,512,784 parameters;
    with Ultralytics' fixed 16-weight DFL convolution, which neither holds
    (the DFL decode is an arange), 60,512,800: the published 60.5 M."""
    with torch.device("meta"):
        port = YoloSeg(ARCH, num_classes=80, dtype=torch.float32)
        ref = ref9.YoloSeg9(ARCH, num_classes=80)
    for model in (port, ref):
        assert sum(p.numel() for p in model.parameters()) == 60_512_784
    assert round((60_512_784 + 16) / 1e5) / 10 == 60.5


def test_the_reference_flops_at_640():
    """One class at imgsz 640: 236.57 GFLOP of convolutions (the published
    248.4 GFLOPs, thop's count, adds BatchNorm and pooling), 48 RepConvs,
    both branches counted: what the benchmark's ``mfu`` reader divides by."""
    with torch.device("meta"):
        ref = ref9.YoloSeg9(ARCH)
    assert model_flops(ref, 640) == 236_567_961_600
    assert sum(isinstance(m, ref9.RepConv) for m in ref.modules()) == 48


def test_the_architecture_is_the_yaml():
    with torch.device("meta"):
        model = YoloSeg(ARCH)
    assert ARCHS[ARCH].family == "v9" and ARCHS[ARCH].scale is None
    assert [cb.widths for cb in model.cblinear] == [CB_WIDTHS[:i + 1] for i in range(5)]
    assert [cb.conv.in_channels for cb in model.cblinear] == [64, 256, 512, 1024, 1024]
    assert all(cb.conv.bias is not None for cb in model.cblinear)
    assert sum(isinstance(m, RepConv) for m in model.modules()) == 48
    assert sum(isinstance(m, yolo.RepNCSPELAN4) for m in model.modules()) == 12
    assert sum(isinstance(m, yolo.ADown) for m in model.modules()) == 8
    assert isinstance(model.backbone2[-1], yolo.SPPELAN)
    # The legacy (YOLOv8) head on 256, 512 and 512 channels, Proto(256, 256, 32).
    assert [h[1][0].conv.in_channels for h in model.heads] == [256, 512, 512]
    assert [h[1][0].conv.groups for h in model.heads] == [1, 1, 1]
    assert model.proto.cv1.conv.out_channels == 256
    with pytest.raises(ValueError, match="no architecture 'yolov9c-seg'"):
        YoloSeg("yolov9c-seg")


def _branches(m: RepConv, x: torch.Tensor) -> torch.Tensor:
    """The RepConv's two branches, each a convolution and BatchNorm by its
    running statistics, summed, then SiLU: Ultralytics' train-time form."""
    def branch(b, pad):
        y = F.conv2d(x, b.conv.weight.float(), None, 1, pad)
        bn = b.bn
        return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    return F.silu(branch(m.conv1, 1) + branch(m.conv2, 0))


def _spread(m: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                b.running_mean.copy_(torch.randn(b.num_features, generator=g))
                b.running_var.copy_(torch.rand(b.num_features, generator=g) + 0.5)
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_folded_repconv_equals_its_two_branches(dtype):
    """The eval-mode RepConv (one 3x3 convolution, the fold in float32, the
    weight cast once to the compute dtype, then the epilogue) against its two
    branches in float32: within float32's rounding of the reordered sums, and
    within bf16's rounding of the folded weight and the input at bf16."""
    m = _spread(RepConv(32, 48, dtype=dtype), 3)
    x = torch.randn(2, 32, 9, 7, generator=torch.Generator().manual_seed(4))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _branches(m, x.float())
        got = m.eval()(x).float()
    scale = float(want.abs().max())
    limit = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((got - want).abs().max()) <= limit * scale
    assert m.conv1.conv.weight.dtype == torch.float32 and m.fused_weight.dtype == dtype


def _convolutions(model, images) -> Counter:
    counts = Counter()

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Count():
        model(images)
    return counts


def test_each_repconv_is_one_convolution_in_eval_mode():
    """48 RepConvs: 48 convolutions a forward in eval mode, 96 in train
    mode; every other convolution once either way."""
    model = YoloSeg(ARCH, dtype=torch.float32)
    images = torch.rand(1, 3, 64, 64)
    blocks = sum(isinstance(m, yolo.ConvBNAct) for m in model.modules())
    others = blocks - 96 + 5 + 9 + 1           # + the CBLinears, the head's 1x1s, Proto's up
    train = _convolutions(model.train(), images)["aten.convolution.default"]
    evald = _convolutions(model.eval(), images)["aten.convolution.default"]
    assert (train, evald) == (others + 96, others + 48)


def test_the_fold_follows_a_load_in_eval_mode():
    model = _model(64)
    images = _images(64)
    with torch.no_grad():
        before = _outputs(model(images))
        state = {k: v * 1.01 if "cv1.conv1.bn.weight" in k else v
                 for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        after = _outputs(model(images))
        fresh = YoloSeg(ARCH, dtype=torch.float32)
        fresh.load_state_dict(state)
        want = _outputs(fresh.eval()(images))
    assert not torch.equal(before[0], after[0])
    for g, w in zip(after, want):
        assert torch.equal(g, w)


# -- the fused CBFuse ----------------------------------------------------------------------

def _interpolate_and_sum(pieces, target):
    """Ultralytics' CBFuse: each piece interpolated to the target's size,
    nearest, the stack summed (here in list order, in float32)."""
    ups = [F.interpolate(p.float(), size=target.shape[2:], mode="nearest") for p in pieces]
    out = ups[0]
    for y in ups[1:] + [target.float()]:
        out = out + y
    return out


def _fusion(k: int, size: int, batch: int = 2, dtype=torch.float32, device="cpu",
            seed: int = 0):
    """Fusion k of a forward whose first level is ``size``: the CBLinear
    outputs of levels k..4 (channels_last, split into their pieces) and the
    target, piece k of each."""
    g = torch.Generator().manual_seed(seed + k)

    def rand(*shape):
        t = torch.randn(shape, generator=g).to(device, dtype)
        return t.contiguous(memory_format=torch.channels_last)

    pieces = []
    for i in range(k, 5):
        s = size >> i
        out = rand(batch, sum(CB_WIDTHS[:i + 1]), s, s)
        pieces.append(out.split(CB_WIDTHS[:i + 1], 1)[k])
    s = size >> k
    return pieces, rand(batch, CB_WIDTHS[k], s, s)


@pytest.mark.parametrize("k", range(5))
def test_the_twin_equals_interpolate_and_sum(k):
    pieces, target = _fusion(k, 64)
    want = _interpolate_and_sum(pieces, target)
    assert torch.equal(cb_fuse_plain(pieces, target), want)
    assert torch.equal(cb_fuse(pieces, target), want)            # the operator on the CPU
    bp, bt = [p.bfloat16() for p in pieces], target.bfloat16()
    got = cb_fuse(bp, bt)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, _interpolate_and_sum(bp, bt).bfloat16())


def test_the_operator_reads_the_slices_where_they_lie():
    """The pieces are views of the CBLinear outputs (pixel stride their
    full channel count), never copied; the result is the target's shape,
    channels_last, a tensor of its own."""
    pieces, target = _fusion(1, 32)
    assert [cuda_cb_fuse._pixel_stride(p) for p in pieces] == [64 + 128, 448, 960, 1984]
    out = cb_fuse(pieces, target)
    assert out.shape == target.shape and out.data_ptr() != target.data_ptr()


def test_the_wrapper_raises_on_what_it_cannot_take():
    pieces, target = _fusion(2, 32)
    with pytest.raises(ValueError, match="one integer factor"):
        cb_fuse([pieces[0][:, :, :3, :3]], target)
    with pytest.raises(ValueError, match="a piece"):
        cb_fuse([pieces[0][:, :128]], target)
    with pytest.raises(ValueError, match="a piece"):
        cb_fuse([pieces[0].double()], target)
    with pytest.raises(ValueError, match="1 to 8"):
        cb_fuse([], target)
    with pytest.raises(ValueError, match="1 to 8"):
        cb_fuse(pieces * 3, target)
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        cb_fuse(pieces, target[0])


def _fake_cuda(*tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda")
                      for t in tensors]


def test_on_fake_cuda_tensors_the_checks_run_before_a_launch():
    pieces, target = _fusion(3, 32, dtype=torch.bfloat16)
    full = [p._base if p._base is not None else p for p in pieces]
    mode, fake = _fake_cuda(target, *full)
    ft, ff = fake[0], fake[1:]
    with mode:
        fp = [f.split(CB_WIDTHS[:i + 4], 1)[3] for i, f in enumerate(ff)]
        out = cb_fuse(fp, ft)
        assert out.shape == target.shape and out.is_contiguous(memory_format=torch.channels_last)
        def nchw(t, dtype=torch.bfloat16):
            return torch.empty(t.shape, dtype=dtype, device="cuda")

        with pytest.raises(ValueError, match="target strides"):
            cb_fuse(fp, nchw(ft))
        with pytest.raises(ValueError, match="not a channels_last view"):
            cb_fuse([nchw(fp[0])] + fp[1:], ft)
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            cb_fuse([nchw(p, torch.float16) for p in fp], nchw(ft, torch.float16))
    assert cuda_cb_fuse.launches == 0


def test_the_card_path_fuses_with_five_operators_and_no_upsample():
    """One eval forward traced on fake CUDA tensors (the served NHWC frame
    permuted): five ``cb_fuse`` operators, no interpolation or index
    gather; every ConvBNAct outside a RepConv and every RepConv ends in one
    epilogue operator; one concatenation (SPPELAN's)."""
    from test_torch_bn_act import _card_graph

    calls, blocks = _card_graph(ARCH, 64, 2, train=False)
    assert calls["vision_assist_tpu_torch.cb_fuse.default"] == 5
    assert not any("upsample" in c or "index_select" in c for c in calls), calls
    epilogues = (calls["vision_assist_tpu_torch.bn_act.default"]
                 + calls["vision_assist_tpu_torch.bn_act_into.default"])
    assert epilogues == blocks - 96 + 48
    assert calls["aten.cat.default"] == 1


def test_in_place_forward_bit_equal_to_the_cat_path():
    """Eval mode under autograd takes the ``torch.cat`` path; outside it, the
    in-place one (1 cat a forward, SPPELAN's): the same head outputs bit for
    bit. The cat path concatenates 49 times: 12 ELAN blocks, their 24
    RepCSPs, 8 ADowns, SPPELAN and the neck's 4."""
    model = _model(64)
    model.requires_grad_(False)
    images = _images(64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        yolo.reset_cat_copies()
        got = _outputs(model(images))
        in_place = yolo.cat_copies
    with torch.enable_grad():
        yolo.reset_cat_copies()
        want = _outputs(model(images))
        by_cat = yolo.cat_copies
    assert in_place == 1
    assert by_cat == 12 + 24 + 8 + 1 + 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_bridge_takes_every_leaf_once():
    with torch.device("meta"):
        shapes = YoloSeg(ARCH, dtype=torch.float32)
        reference = ref9.YoloSeg9(ARCH)
    paths = [p for _, p, _ in flax_leaves(shapes)]
    assert len(paths) == len(set(paths))
    assert paths == [p for _, p, _ in ref9.flax_leaves(reference)]
    assert ("params", "CBLinear_4", "Conv_0", "bias") in paths
    tree = _tree(64)
    model = YoloSeg(ARCH, dtype=torch.float32)
    model.load_state_dict(convert_flax_variables(tree, model))
    back = to_flax_variables(model)

    def flat(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, path + (k,))
        else:
            yield path, np.asarray(t)

    assert dict(flat(back)).keys() == dict(flat(tree)).keys()
    for path, value in flat(tree):
        node = back
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(node, value, err_msg=str(path))
    bad = dict(tree, params=dict(tree["params"], Extra_0={"bias": np.ones(4, np.float32)}))
    with pytest.raises(ValueError, match="not consumed"):
        convert_flax_variables(bad, YoloSeg(ARCH, dtype=torch.float32))


def test_the_seeded_draw_is_the_seeds():
    """``harness.weights.draw`` on the reference: every leaf of the bridge,
    the same tree from the same seed, another from another."""
    tree = _tree(64)
    again = draw(ref9, _config(64), SEED, "cpu")
    other = draw(ref9, _config(64), SEED + 1, "cpu")
    leaf = tree["params"]["CBLinear_2"]["Conv_0"]["kernel"]
    assert leaf.shape == (1, 1, 512, 64 + 128 + 256)
    np.testing.assert_array_equal(again["params"]["CBLinear_2"]["Conv_0"]["kernel"], leaf)
    assert not np.array_equal(other["params"]["CBLinear_2"]["Conv_0"]["kernel"], leaf)


def test_served_through_the_batched_server():
    """``ModelConfig(arch="yolov9e-seg")`` through ``Segmenter``,
    ``MultiStreamProcessor`` and ``BatchedStreamingServer`` (depth 2, 2
    streams, 3 steps of 320x320 walkways at imgsz 64): every frame
    answered, as the synchronous ``process_frames`` answers it."""
    h = w = 320
    seg = Segmenter(config.ModelConfig(arch=ARCH, imgsz=64, dtype="float32"),
                    variables=_tree(64), example_hw=(h, w), device="cpu")
    cfg = config.PipelineConfig(frame_height=h, frame_width=w, num_streams=2,
                                pathfinder=config.PathFinderConfig(engine="exact_device"))
    frames = walkway_frames(6, h, w, seed=9)
    steps = [np.stack(frames[2 * i:2 * i + 2]) for i in range(3)]

    def guidance(results):
        return [(r.final_answer, [[(c.row, c.col) for c in p.cells] for p in r.paths])
                for r in results]

    want = [guidance(MultiStreamProcessor(cfg, segmenter=seg, device="cpu")
                     .process_frames(s, now_ms=33 * i)) for i, s in enumerate(steps)]
    srv = BatchedStreamingServer(MultiStreamProcessor(cfg, segmenter=seg, device="cpu"), 2)
    got = []
    for i, s in enumerate(steps):
        got.extend(srv.feed(s, now_ms=33 * i))
    got.extend(srv.drain())
    assert [guidance(r) for r in got] == want
    assert len(want) == 3 and all(len(step) == 2 for step in want)


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", range(5))
def test_kernel_equals_its_twin_at_the_served_fusions(cuda, k, dtype):
    """Fusion k at imgsz 640 and batch 8 (targets 320x320x64 down to
    20x20x1024, pieces read from their CBLinear outputs in place): one
    launch, bit for bit the twin run on the card."""
    pieces, target = _fusion(k, 320, batch=8, dtype=dtype, device=cuda, seed=7)
    cuda_cb_fuse.reset_launches()
    got = cb_fuse(pieces, target)
    torch.cuda.synchronize()
    assert cuda_cb_fuse.launches == 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, cb_fuse_plain(pieces, target))


@pytest.mark.cuda
def test_scalar_form_equals_the_twin(cuda):
    """Channels off the 16-byte pack (12) and a slice at an 8-byte offset:
    the scalar form, bit for bit the twin."""
    g = torch.Generator().manual_seed(5)
    full = torch.randn(2, 28, 4, 6, generator=g).to(cuda, torch.bfloat16)
    full = full.contiguous(memory_format=torch.channels_last)
    target = torch.randn(2, 12, 8, 12, generator=g).to(cuda, torch.bfloat16)
    target = target.contiguous(memory_format=torch.channels_last)
    piece = full[:, 4:16]
    got = cb_fuse([piece, target], target)
    torch.cuda.synchronize()
    assert torch.equal(got, cb_fuse_plain([piece, target], target))


@pytest.mark.cuda
def test_a_served_forward_launches_five_fusions(cuda):
    model = YoloSeg(ARCH).eval().to(cuda)
    images = torch.rand(2, 256, 256, 3, device=cuda).permute(0, 3, 1, 2)
    cuda_cb_fuse.reset_launches()
    cuda_bn_act.reset_launches()
    with torch.no_grad():
        model(images)
    torch.cuda.synchronize()
    blocks = sum(isinstance(m, yolo.ConvBNAct) for m in model.modules())
    assert cuda_cb_fuse.launches == 5
    assert cuda_bn_act.launches == blocks - 96 + 48
