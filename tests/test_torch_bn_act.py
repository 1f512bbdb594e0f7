"""The ConvBNAct epilogue (``ops/cuda_bn_act.py``, ``csrc/bn_act.cu``):
BatchNorm by the running statistics in float32, SiLU, and the cast back to
the convolution's dtype, as one operator.

On the CPU the operator is the plain twin, held against the float64
evaluation of the same formula and against PyTorch's ``F.batch_norm`` and
``F.silu``, the chain eval mode ran before. The two formulae round at other
places (PyTorch folds the statistics into ``x * alpha + beta``; the twin
computes ``(x - mean) * mul + bias``, Flax's order), so their difference is
bounded by the rounding error of each, at the scale of the terms they add,
``S = (|x| + |mean|) |mul| + |bias|``, and not at the scale of a result that
cancels to near 0. The wrapper's checks, the operator on the served card path
(traced with fake CUDA tensors: no card needed) and in train mode are tested
here too.

On a card (marked ``cuda``): the kernel bit for bit its twin run on the card
at every ConvBNAct output shape of yolo11n-seg at imgsz 256 with batch 8 and
of yolov8n-seg at 640 with batch 1, in both layouts, bf16 and float32, with
and without SiLU; its scalar forms, on channels or planes off the 16-byte
pack and on an input at a misaligned address; its launch count; and the
flagship's served forward, each block within one bf16 step of the cuDNN chain
on the same convolution output.
This file imports no JAX.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import pytest
import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.ops import cuda_bn_act
from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act, bn_act_into, bn_act_plain

torch.set_num_threads(2)

EPS = 1e-3
F32_STEP = 2.0 ** -23          # a float32 ulp at 1.0


def _stats(c: int, seed: int, device="cpu"):
    """weight, bias, running mean and running variance of c channels, as
    trained statistics spread: float32."""
    g = torch.Generator().manual_seed(seed)
    weight = torch.randn(c, generator=g) * 2
    bias = torch.randn(c, generator=g)
    mean = torch.randn(c, generator=g) * 2
    var = torch.rand(c, generator=g) * 4 + 0.01
    return [t.to(device) for t in (weight, bias, mean, var)]


def _activations(shape, seed: int, channels_last: bool, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 3).to(device, dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _term_scale(x, weight, mean, var, bias):
    """S: the magnitudes of the terms both formulae add, a element."""
    mul = (weight / torch.sqrt(var + EPS)).abs().view(-1, 1, 1)
    return (x.float().abs() + mean.abs().view(-1, 1, 1)) * mul + bias.abs().view(-1, 1, 1)


def _chain(x, weight, bias, mean, var, act):
    """Eval mode's former chain: float32 BatchNorm, SiLU, the cast back."""
    y = F.batch_norm(x.float(), mean, var, weight, bias, False, 0.0, EPS)
    return (F.silu(y) if act else y).to(x.dtype)


def _bf16_step(t):
    """One bf16 ulp at |t| (the spacing of bf16 numbers there)."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


CASES = [((4, 16, 16, 16), 0), ((4, 64, 16, 16), 1), ((2, 256, 8, 8), 2),
         ((3, 24, 5, 7), 3)]


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape,seed", CASES)
def test_plain_twin_within_three_float32_ulp_of_the_exact_epilogue(shape, seed, act):
    """Against the same epilogue in float64 on the same float32 inputs (eps
    as float32 rounds it): within 3 * 2^-23 * S (each step of the twin
    rounds once, the scale twice, SiLU's exp within its ulp)."""
    x = _activations(shape, seed, channels_last=False)
    weight, bias, mean, var = _stats(shape[1], seed)
    got = bn_act_plain(x, weight, bias, mean, var, EPS, act).double()
    eps64 = torch.tensor(EPS, dtype=torch.float32).double()
    mul = weight.double() / torch.sqrt(var.double() + eps64)
    y = (x.double() - mean.double().view(-1, 1, 1)) * mul.view(-1, 1, 1) \
        + bias.double().view(-1, 1, 1)
    want = y * torch.sigmoid(y) if act else y
    err = (got - want).abs() / (F32_STEP * _term_scale(x, weight, mean, var, bias).double())
    assert float(err.max()) <= 3.0


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape,seed", CASES)
def test_plain_twin_against_batch_norm_and_silu(shape, seed, act):
    """In float32 within 5 * 2^-23 * S of F.batch_norm (then F.silu): the
    sum of the two formulae's bounds against the exact value (the twin's 3
    above; PyTorch's ~2). After the cast to bf16: equal but for a few
    elements, each within one bf16 ulp of the larger, or within that
    float32 bound where the result cancels to near 0."""
    x = _activations(shape, seed, channels_last=False)
    weight, bias, mean, var = _stats(shape[1], seed)
    scale = F32_STEP * _term_scale(x, weight, mean, var, bias)
    got = bn_act_plain(x, weight, bias, mean, var, EPS, act)
    want = _chain(x, weight, bias, mean, var, act)
    assert float(((got - want).abs() / scale).max()) <= 5.0
    gb, wb = got.bfloat16().float(), want.bfloat16().float()
    step = torch.maximum(_bf16_step(torch.maximum(gb.abs(), wb.abs())), 5.0 * scale)
    assert bool(((gb - wb).abs() <= step).all())
    assert float((gb != wb).float().mean()) < 1e-3


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operator_on_the_cpu_is_the_twin_in_the_inputs_layout(channels_last, dtype):
    x = _activations((2, 24, 6, 5), 7, channels_last, dtype)
    stats = _stats(24, 7)
    cuda_bn_act.reset_launches()
    for act in (True, False):
        got = bn_act(x, *stats, EPS, act)
        assert torch.equal(got, bn_act_plain(x, *stats, EPS, act))
        assert got.dtype == dtype and got.stride() == x.stride()
    assert cuda_bn_act.launches == 0


@pytest.mark.parametrize("act", [True, False])
def test_eval_convbnact_is_the_convolution_then_the_twin(act):
    """Eval mode: the bf16 convolution's output through the operator (here
    the twin), with the module's own running statistics."""
    torch.manual_seed(3)
    block = yolo.ConvBNAct(8, 16, 3, 2, act=act).eval()
    with torch.no_grad():
        block.bn.running_mean.uniform_(-1, 1)
        block.bn.running_var.uniform_(0.5, 2)
        block.bn.weight.uniform_(-2, 2)
        block.bn.bias.uniform_(-1, 1)
        x = torch.rand(2, 8, 9, 9).bfloat16()
        y = F.conv2d(yolo._pad_same(x, 3, 2), block.conv.weight, None, 2)
        bn = block.bn
        want = bn_act_plain(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                            bn.eps, act)
        assert torch.equal(block(x), want)


def test_eval_convbnact_stores_a_contiguous_convolution_output_into_a_slice():
    """A convolution whose output is contiguous NCHW (what the card's layout
    rule can answer inside a program that torch.export traces) still stores
    into its slice of a channels_last buffer: the slice equals the block's
    own result, the buffer's other channels untouched."""
    torch.manual_seed(4)
    block = yolo.ConvBNAct(8, 16, 3).eval()
    with torch.no_grad():
        block.bn.running_mean.uniform_(-1, 1)
        block.bn.running_var.uniform_(0.5, 2)
        x = torch.rand(2, 8, 9, 9).bfloat16()       # NCHW: so is the convolution's output
        out, buf = _wide((2, 16, 9, 9), 8, 32, torch.bfloat16)
        block(x, out=out)
        assert torch.equal(out, block(x))
        assert bool(torch.cat([buf[:, :8], buf[:, 24:]], dim=1).isnan().all())


def test_wrapper_raises_on_what_it_cannot_take():
    x = _activations((2, 16, 4, 6), 0, channels_last=False)
    stats = _stats(16, 0)
    with pytest.raises(ValueError, match="neither channels_last nor contiguous"):
        bn_act(x[:, :, :, ::2], *stats, EPS, True)
    with pytest.raises(ValueError, match="neither channels_last nor contiguous"):
        bn_act(x.permute(0, 1, 3, 2), *stats, EPS, True)
    with pytest.raises(ValueError, match="16 channels"):
        bn_act(x, *_stats(8, 0), EPS, True)
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        bn_act(x[0], *stats, EPS, True)


def _wide(shape, at: int, width: int, dtype=torch.float32, device="cpu"):
    """A channel slice [at, at + C) of a channels_last buffer of ``width``
    channels, filled with NaN, and the buffer."""
    n, c, h, w = shape
    buf = torch.full((n, width, h, w), float("nan"), dtype=dtype, device=device).contiguous(
        memory_format=torch.channels_last)
    return buf[:, at:at + c], buf


INTO_C, INTO_WIDTH = 32, 56
INTO_CASES = [(at, also_from) for at in (0, 8, INTO_WIDTH - INTO_C)
              for also_from in (None, 0, 8, INTO_C - 8)]


def _check_into_case(at, also_from, dtype, device, act=True, seed=0):
    """bn_act_into ``x`` (8 frames, 32 channels at 5x7) into a slice at ``at``
    of a 56-channel buffer, and its channels from ``also_from`` into a
    tensor of their own: both bit-equal to the plain twin, the buffer's
    other channels untouched."""
    shape = (8, INTO_C, 5, 7)
    x = _activations(shape, seed, True, dtype, device)
    stats = _stats(INTO_C, seed, device)
    out, buf = _wide(shape, at, INTO_WIDTH, dtype, device)
    also = None
    if also_from is not None:
        also = torch.empty((8, INTO_C - also_from, 5, 7), dtype=dtype, device=device,
                           memory_format=torch.channels_last)
    cuda_bn_act.reset_launches()
    assert bn_act_into(x, *stats, EPS, act, out, also) is out
    want = bn_act_plain(x, *stats, EPS, act)
    assert cuda_bn_act.view_stores == 1
    assert torch.equal(out, want)
    if also is not None:
        assert torch.equal(also, want[:, also_from:])
    rest = torch.cat([buf[:, :at], buf[:, at + INTO_C:]], dim=1)
    assert bool(rest.isnan().all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("at,also_from", INTO_CASES)
def test_into_a_slice_equals_bn_act_on_the_cpu(at, also_from, dtype):
    for act in (True, False):
        _check_into_case(at, also_from, dtype, "cpu", act)
    assert cuda_bn_act.launches == 0


def test_into_raises_on_a_view_that_does_not_fit():
    """A slice off the 16-byte pack, a wrong shape or dtype, an ``out`` or
    ``also`` that is not channels_last, an input that is not: the same
    checks on every device."""
    shape = (2, 16, 4, 6)
    x = _activations(shape, 0, True, torch.bfloat16)
    stats = _stats(16, 0)
    ok, _ = _wide(shape, 8, 32, torch.bfloat16)
    bn_act_into(x, *stats, EPS, True, ok)
    for at, match in ((4, "off the 16-byte pack"), (1, "off the 16-byte pack")):
        out, _ = _wide(shape, at, 32, torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            bn_act_into(x, *stats, EPS, True, out)
    with pytest.raises(ValueError, match="off the 16-byte pack"):        # pixel stride 20
        bn_act_into(x, *stats, EPS, True, _wide(shape, 0, 20, torch.bfloat16)[0])
    with pytest.raises(ValueError, match="out"):
        bn_act_into(x, *stats, EPS, True, _wide((2, 8, 4, 6), 0, 32, torch.bfloat16)[0])
    with pytest.raises(ValueError, match="out"):
        bn_act_into(x, *stats, EPS, True, _wide(shape, 0, 32, torch.float32)[0])
    nchw = torch.empty(2, 32, 4, 6, dtype=torch.bfloat16)[:, 8:24]
    with pytest.raises(ValueError, match="not a channels_last view"):
        bn_act_into(x, *stats, EPS, True, nchw)
    with pytest.raises(ValueError, match="x must be channels_last"):
        bn_act_into(x.contiguous(), *stats, EPS, True, ok)
    with pytest.raises(ValueError, match="not a whole number"):
        x12 = _activations((2, 12, 4, 6), 0, True, torch.bfloat16)
        bn_act_into(x12, *_stats(12, 0), EPS, True, _wide((2, 12, 4, 6), 0, 16,
                                                           torch.bfloat16)[0])
    for also in (torch.empty(2, 4, 4, 6, dtype=torch.bfloat16,
                             memory_format=torch.channels_last),       # from channel 12
                 torch.empty(2, 8, 4, 6, dtype=torch.bfloat16),         # NCHW
                 torch.empty(2, 24, 4, 6, dtype=torch.bfloat16,
                             memory_format=torch.channels_last)):      # wider than x
        with pytest.raises(ValueError, match="also"):
            bn_act_into(x, *stats, EPS, True, ok, also)


def _fake_cuda(*tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda")
                      for t in tensors]


def test_wrapper_raises_on_a_cuda_tensor_the_kernel_cannot_take():
    """Fake CUDA tensors (no card needed): the checks run in the operator's
    fake implementation as on the card, before any launch."""
    x = _activations((2, 16, 4, 6), 0, channels_last=True)
    stats = _stats(16, 0)
    mode, (xc, *sc) = _fake_cuda(x, *stats)
    with mode:
        assert bn_act(xc, *sc, EPS, True).stride() == x.stride()
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            bn_act(xc.half(), *sc, EPS, True)
        with pytest.raises(ValueError, match="float32 statistics"):
            bn_act(xc, sc[0].double(), *sc[1:], EPS, True)
        with pytest.raises(ValueError, match="float32 statistics"):
            bn_act(xc, *stats, EPS, True)                     # statistics on the CPU
        c = cuda_bn_act.MAX_CHANNELS
        for wide in (torch.empty(1, c + 8, 2, 2, device="cuda"),
                     torch.empty(1, 2, 2, c + 8, device="cuda").permute(0, 3, 1, 2)):
            with pytest.raises(ValueError, match=f"{c + 8} channels"):
                bn_act(wide, *[torch.empty(c + 8, device="cuda")] * 4, EPS, True)
        assert bn_act(torch.empty(1, c, 2, 2, device="cuda"),
                      *[torch.empty(c, device="cuda")] * 4, EPS, True).shape == (1, c, 2, 2)
        strided = torch.empty_strided((2, 16, 4, 3), (384, 24, 6, 2), device="cuda")
        with pytest.raises(ValueError, match="neither channels_last nor contiguous"):
            bn_act(strided, *sc, EPS, True)
    assert cuda_bn_act.launches == 0


def _cudnn_memory_format(x, weight, backend):
    """cuDNN's choice of a convolution's output layout: channels_last where
    the input's or the weight's strides suggest it (a channel slice of a
    channels_last tensor among them, as cuDNN's own rule reads them). A
    build without CUDA has no cuDNN backend to select, and its fake
    convolutions on CUDA tensors answer contiguous NCHW whatever the input,
    which the card never does."""
    def suggests(t):
        n, c, h, w = t.stride()
        return t.is_contiguous(memory_format=torch.channels_last) or (
            c == 1 and n >= h >= w >= t.shape[1])

    return torch.channels_last if suggests(x) or suggests(weight) else torch.contiguous_format


def _card_graph(arch: str, imgsz: int, batch: int, train: bool):
    """The operators of one forward of ``arch`` on fake CUDA tensors: the
    served NHWC frame permuted, as Segmenter._frame_chain hands it, each
    convolution's output in eval mode laid out as cuDNN lays it out."""
    from unittest import mock

    from torch.fx.experimental.proxy_tensor import make_fx

    model = yolo.YoloSeg(arch).train(train)
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    mode, fake = _fake_cuda(*named.values())
    state = dict(zip(named, fake))
    # In train mode the layout decides nothing, and the fake batch norm's
    # decomposition cannot run channels_last on CUDA tensors without CUDA.
    layout = (contextlib.nullcontext() if train else mock.patch.object(
        torch._C, "_conv_determine_backend_memory_format", _cudnn_memory_format))
    with mode, layout:
        x = torch.empty(batch, imgsz, imgsz, 3, device="cuda").permute(0, 3, 1, 2)
        with torch.set_grad_enabled(train):
            graph = make_fx(lambda im: torch.func.functional_call(model, state, (im,)).protos,
                            tracing_mode="fake")(x).graph
    calls = Counter(str(n.target) for n in graph.nodes if n.op == "call_function")
    blocks = sum(isinstance(m, yolo.ConvBNAct) for m in model.modules())
    return calls, blocks


@pytest.mark.parametrize("arch", ["yolo11n-seg", "yolov8n-seg"])
def test_the_served_card_path_ends_each_convolution_in_one_operator(arch):
    """In eval mode every ConvBNAct (90 in yolo11n-seg) is a convolution and
    one call of the operator, ``bn_act`` or, where it stores into a
    concatenation's slice, ``bn_act_into``: no BatchNorm, SiLU or float32
    cast left, and one concatenation (SPPF's)."""
    calls, blocks = _card_graph(arch, 64, 2, train=False)
    assert blocks == {"yolo11n-seg": 90, "yolov8n-seg": 66}[arch]
    into = calls["vision_assist_tpu_torch.bn_act_into.default"]
    assert calls["vision_assist_tpu_torch.bn_act.default"] + into == blocks
    assert into == {"yolo11n-seg": 21, "yolov8n-seg": 18}[arch]
    assert calls["aten.cat.default"] == 1
    assert not any("batch_norm" in c or "silu" in c or "sigmoid" in c for c in calls), calls


def test_train_mode_never_calls_the_operator():
    calls, blocks = _card_graph("yolo11n-seg", 64, 2, train=True)
    assert calls["vision_assist_tpu_torch.bn_act.default"] == 0
    assert sum(n for c, n in calls.items() if "batch_norm" in c) == blocks


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _served_blocks(model, images):
    """(module, its output) of every ConvBNAct in one eval forward."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, o)))
             for m in model.modules() if isinstance(m, yolo.ConvBNAct)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("arch,imgsz,batch", [("yolo11n-seg", 256, 8), ("yolov8n-seg", 640, 1),
                                              ("yolo12x-seg", 640, 8)])
def test_kernel_equals_its_twin_at_every_served_shape(cuda, arch, imgsz, batch):
    """Every ConvBNAct output shape of ``arch`` at ``imgsz`` and ``batch``
    (the served NHWC frame permuted, so channels_last), in both layouts, bf16
    and float32, SiLU on and off: the kernel bit for bit the twin run on the
    card, one launch a call."""
    model = yolo.YoloSeg(arch).eval().to(cuda)
    images = torch.rand(batch, imgsz, imgsz, 3, device=cuda).permute(0, 3, 1, 2)
    shapes = sorted({tuple(o.shape) for _, o in _served_blocks(model, images)})
    for i, shape in enumerate(shapes):
        stats = _stats(shape[1], i, cuda)
        for channels_last in (True, False):
            for dtype in (torch.bfloat16, torch.float32):
                x = _activations(shape, i, channels_last, dtype, cuda)
                for act in (True, False):
                    cuda_bn_act.reset_launches()
                    got = bn_act(x, *stats, EPS, act)
                    torch.cuda.synchronize()
                    assert cuda_bn_act.launches == 1
                    want = bn_act_plain(x, *stats, EPS, act)
                    assert got.stride() == x.stride() and got.dtype == dtype
                    assert torch.equal(got, want), (shape, channels_last, dtype, act)


def _misaligned(shape, seed, channels_last, dtype, device):
    """The activations at a storage offset of one element, so their address
    is not a multiple of 16 B."""
    x = _activations(shape, seed, channels_last, dtype, device)
    n, c, h, w = shape
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
    if channels_last:
        out = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    else:
        out = buf[1:].view(shape)
    out.copy_(x)
    assert out.data_ptr() % 16 and out.stride() == x.stride()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["channels_off_the_pack", "misaligned"])
def test_scalar_forms_equal_the_twin(cuda, case):
    """The kernel's scalar forms (a pack of one element), which no served
    shape takes: channels or planes not a multiple of 16 B (C = 12 or 10 and
    a 5x7 plane, as a deepest plane at a small imgsz), and an input at a
    storage offset. Each, in both layouts and dtypes, SiLU on and off, is one
    launch of the form the layout, alignment and dtype call for (``<T, 1>``
    but for float32 channels_last with C = 12, a whole number of 4-float
    packs) and bit for bit the twin run on the card."""
    import re

    from torch.profiler import ProfilerActivity, profile

    shapes = ([(3, 12, 5, 7), (3, 10, 5, 7)] if case == "channels_off_the_pack"
              else [(8, 64, 32, 32), (2, 16, 8, 8)])
    for i, shape in enumerate(shapes):
        stats = _stats(shape[1], 10 + i, cuda)
        for channels_last in (True, False):
            for dtype in (torch.bfloat16, torch.float32):
                if case == "misaligned":
                    x = _misaligned(shape, i, channels_last, dtype, cuda)
                else:
                    x = _activations(shape, i, channels_last, dtype, cuda)
                for act in (True, False):
                    cuda_bn_act.reset_launches()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        got = bn_act(x, *stats, EPS, act)
                        torch.cuda.synchronize()
                    assert cuda_bn_act.launches == 1
                    forms = [re.search(r"bn_act_(nhwc|nchw)<[^>]*?,\s*(\d+)>", e.key)
                             for e in prof.key_averages() if "bn_act_" in e.key]
                    pack = 16 // x.element_size()
                    inner = shape[1] if channels_last else shape[2] * shape[3]
                    packed = case != "misaligned" and inner % pack == 0
                    want_form = ("nhwc" if channels_last else "nchw",
                                 str(pack if packed else 1))
                    assert [f and f.groups() for f in forms] == [want_form], \
                        (forms, shape, channels_last, dtype)
                    want = bn_act_plain(x, *stats, EPS, act)
                    assert got.stride() == x.stride() and got.dtype == dtype
                    assert torch.equal(got, want), (shape, channels_last, dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("at,also_from", INTO_CASES)
def test_into_a_slice_equals_the_twin_on_the_card(cuda, at, also_from, dtype):
    """The CPU cases on the card: one launch, bit for bit the twin's
    result in the slice and in ``also``, the rest of the buffer untouched;
    and an address off the pack raises before any launch."""
    for act in (True, False):
        _check_into_case(at, also_from, dtype, cuda, act)
        torch.cuda.synchronize()
        assert cuda_bn_act.launches == 1
    x = _activations((2, 16, 4, 6), 0, True, dtype, cuda)
    out, _ = _wide((2, 16, 4, 6), 1, 32, dtype, cuda)
    cuda_bn_act.reset_launches()
    with pytest.raises(ValueError, match="off the 16-byte pack"):
        bn_act_into(x, *_stats(16, 0, cuda), EPS, True, out)
    assert cuda_bn_act.launches == cuda_bn_act.view_stores == 0


@pytest.mark.cuda
def test_launches_count_the_blocks_of_an_eval_forward_and_none_in_train(cuda):
    model = yolo.YoloSeg("yolo11n-seg", param_dtype=torch.float32).to(cuda)
    blocks = sum(isinstance(m, yolo.ConvBNAct) for m in model.modules())
    images = torch.rand(8, 256, 256, 3, device=cuda).permute(0, 3, 1, 2)
    cuda_bn_act.reset_launches()
    with torch.no_grad():
        model.eval()(images)
    torch.cuda.synchronize()
    assert cuda_bn_act.launches == blocks == 90
    assert cuda_bn_act.view_stores == 21
    cuda_bn_act.reset_launches()
    model.train()(images)
    torch.cuda.synchronize()
    assert cuda_bn_act.launches == 0


@pytest.mark.cuda
def test_served_forward_within_one_bf16_step_of_the_cudnn_chain(cuda, monkeypatch):
    """The flagship's served forward (8 letterboxed walkways through
    Segmenter._frame_chain): at every ConvBNAct, the kernel's output and the
    former chain (F.batch_norm, F.silu) on the same convolution output are
    equal but for a few elements, each within one bf16 ulp of the larger, or
    within 5 * 2^-23 * S where the result cancels to near 0 (the float32
    bound of the CPU test above)."""
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter

    variables = flagship.load_flagship_variables()
    if variables is None:
        pytest.skip("flagship weights missing from assets/weights")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    seg = Segmenter(flagship.model_config(), variables=variables,
                    example_hw=(1280, 720), device=cuda)
    frames = torch.from_numpy(walkway_frames(8, 1280, 720, seed=5)).to(cuda)
    compared, differ, total = 0, 0, 0

    def check(m, inputs, out):
        nonlocal compared, differ, total
        (x,) = inputs
        conv, bn = m.conv, m.bn
        # The convolution as the forward calls it: the pad its own where it
        # takes it (a padded copy would give cuDNN another call to choose for).
        w0, _, h0, _ = pads = yolo._same_pads(x, m.kernel, m.stride)
        copied = m.pads_with_a_copy(x)
        y = F.conv2d(F.pad(x, pads) if copied else x, conv.weight.to(m.dtype), None,
                     conv.stride, 0 if copied else (h0, w0), 1, conv.groups)
        stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        assert torch.equal(out, bn_act(y, *stats, bn.eps, m.act))      # deterministic
        want = _chain(y, *stats, m.act).float()
        got = out.float()
        scale = F32_STEP * _term_scale(y, bn.weight, bn.running_mean, bn.running_var,
                                       bn.bias)
        step = torch.maximum(_bf16_step(torch.maximum(got.abs(), want.abs())), 5.0 * scale)
        assert bool(((got - want).abs() <= step).all()), type(m)
        compared += 1
        differ += int((got != want).sum())
        total += got.numel()

    hooks = [m.register_forward_hook(check) for m in seg.model.modules()
             if isinstance(m, yolo.ConvBNAct)]
    try:
        seg._frame_chain(frames)
    finally:
        for h in hooks:
            h.remove()
    assert compared == 90
    assert differ / total < 1e-2, (differ, total)
