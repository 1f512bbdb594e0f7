"""YOLOv9's ADown pools as one operator (``ops/cuda_adown.py``,
``csrc/adown.cu``): the 2x2 stride-1 average pool, the channel split and the
3x3 stride-2 max pool of the second half, in one pass.

On the CPU the operator is its plain twin, ``adown_pool_plain``, which is
ATen's chain (``F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)``, then
``F.max_pool2d(second, 3, 2, 1)``) with both halves made contiguous in x's
memory format: held bit for bit against that chain at the input shapes of
YOLOv9e-seg's 8 ADowns at imgsz 640, at odd, non-square and smallest sizes,
in bf16 and float32, NaN and infinities included; a PyTorch emulation of the
kernel's walk (``csrc/adown.cu``: strips, halves, column groups, edges) held
against the twin the same way. Its fake implementation's
shapes and layouts, its checks (on fake CUDA tensors where the card's
differ: no card needed), its launch count, train mode (the twin, gradients
reach x), ``ADown``'s eval forward against the chain it ran before, and the
card path of a YOLOv9e-seg forward (8 operators, no average pool left) are
tested here too.

On a card (marked ``cuda``): the kernel bit for bit its twin and the ATen
chain at the 8 served shapes with batch 8, in bf16 and float32, with NaN,
infinities and signed zeros among the inputs, one launch a call; the small
and odd sizes; its refusals. This file imports no JAX.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.ops import cuda_adown
from vision_assist_tpu_torch.ops.cuda_adown import adown_pool, adown_pool_plain, pooled_shapes

torch.set_num_threads(2)

# The input (C, H, W) of each ADown of a YOLOv9e-seg forward at imgsz 640:
# three in each backbone (after P2, P3 and P4), then the neck's d1 and d2.
SERVED = {
    "backbone1.p2": (256, 160, 160), "backbone1.p3": (512, 80, 80),
    "backbone1.p4": (1024, 40, 40), "backbone2.p2": (256, 160, 160),
    "backbone2.p3": (512, 80, 80), "backbone2.p4": (1024, 40, 40),
    "neck.d1": (256, 80, 80), "neck.d2": (512, 40, 40),
}
# Odd, non-square and the smallest sizes the pools take.
ODD = [(16, 7, 9), (16, 9, 6), (16, 2, 2), (16, 3, 3), (32, 2, 7), (16, 5, 2), (48, 13, 11)]


def _input(shape, dtype=torch.bfloat16, seed=0, specials=False, device="cpu",
           channels_last=True) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if specials:
        # NaN, both infinities and signed zeros at seeded places, about 1 in
        # 300 each, and ones, which tie.
        pick = torch.randint(0, 300, shape, generator=g)
        for k, v in enumerate([float("nan"), float("inf"), -float("inf"), -0.0, 0.0]):
            x[pick == k] = v
        x[pick == 5] = 1.0
    x = x.to(device, dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _chain(x):
    """What ``ADown.forward`` ran before the operator: ATen's average pool,
    its halves as views, the max pool of the second."""
    a, b = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
    return a, F.max_pool2d(b, 3, 2, 1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _bit_equal(got, want) -> bool:
    return got.shape == want.shape and torch.equal(_bits(got), _bits(want))


# -- on the CPU ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SERVED.values()) + ODD,
                         ids=list(SERVED) + [f"{c}x{h}x{w}" for c, h, w in ODD])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_twin_and_the_operator_are_the_aten_chain(shape, dtype):
    x = _input((1, *shape), dtype, seed=sum(shape), specials=True)
    want = _chain(x)
    twin = adown_pool_plain(x)
    got = adown_pool(x)
    for w, t, g, s in zip(want, twin, got, pooled_shapes(x.shape)):
        assert tuple(w.shape) == s
        assert _bit_equal(t, w) and _bit_equal(g, w)
        assert t.is_contiguous(memory_format=torch.channels_last)
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert g.dtype == dtype


def test_the_twin_keeps_an_nchw_input_nchw():
    x = _input((2, 16, 9, 8), torch.float32, seed=3, channels_last=False)
    for t, w in zip(adown_pool_plain(x), _chain(x)):
        assert t.is_contiguous() and torch.equal(t, w)


def test_the_served_shapes_are_the_models():
    """The 8 ADowns of YOLOv9e-seg at imgsz 640 see SERVED's inputs, in
    order (the benchmark's reference module, on the meta device)."""
    from benchmark.reference import yolov9 as ref9

    seen = []
    with torch.device("meta"):
        model = ref9.build_model({"arch": "yolov9e-seg", "num_classes": 1, "reg_max": 16,
                                  "num_mask_coeffs": 32})
    for m in model.modules():
        if isinstance(m, ref9.ADown):
            m.register_forward_hook(lambda m, i, o: seen.append(tuple(i[0].shape[1:])))
    with torch.no_grad():
        model(torch.zeros(1, 3, 640, 640, device="meta"))
    assert sorted(seen) == sorted(SERVED.values())


def _emulate(x: torch.Tensor, rows: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/adown.cu``'s rule in PyTorch, thread by thread: thread (n,
    strip, half, column group j, pack q) walks its strip of ``rows``
    max-pool rows a row at a time, float32 sums from 0, each average over 4
    rounded to x's dtype, the max-pool scan's rule (larger or NaN replaces)
    over each window row, then over the rows in order. Packs of 8 bf16 or 4
    float32 channels, as the kernel's."""
    n_, c, h, w = x.shape
    v = 16 // x.element_size()
    half, packs, groups, out_h = c // 2, c // 2 // v, w // 2, h // 2
    strips = -(-out_h // rows)
    xs = x.permute(0, 2, 3, 1).float()                     # (N, H, W, C) values
    avg = torch.empty(n_, h - 1, w - 1, half, dtype=x.dtype)
    mx = torch.empty(n_, out_h, groups, half, dtype=x.dtype)

    def row_sum(left, right):
        return (torch.zeros_like(left) + left) + right

    def average(total, left, right):
        return (((total + left) + right) * 0.25).to(x.dtype)

    def take(best, nxt):
        b, t = best.float(), nxt.float()
        return torch.where((t > b) | torch.isnan(t), nxt, best)

    for n in range(n_):
        for strip in range(strips):
            oy0 = strip * rows
            oy1 = min(oy0 + rows, out_h)
            for second in (False, True):
                for j in range(groups):
                    for q in range(packs):
                        right = 2 * j + 2 < w
                        ch = (half if second else 0) + q * v

                        def load(r, col):
                            return xs[n, r, col, ch:ch + v]

                        if not second:
                            col, end = 2 * j, min(2 * oy1, h - 1)
                            s0 = row_sum(load(2 * oy0, col), load(2 * oy0, col + 1))
                            if right:
                                s1 = row_sum(load(2 * oy0, col + 1), load(2 * oy0, col + 2))
                            for y in range(2 * oy0, end):
                                c0, c1 = load(y + 1, col), load(y + 1, col + 1)
                                avg[n, y, col, q * v:q * v + v] = average(s0, c0, c1)
                                s0 = row_sum(c0, c1)
                                if right:
                                    c2 = load(y + 1, col + 2)
                                    avg[n, y, col + 1, q * v:q * v + v] = average(s1, c1, c2)
                                    s1 = row_sum(c1, c2)
                            continue
                        col, left = 2 * j, j > 0
                        first, last = max(2 * oy0 - 1, 0), min(2 * oy1 - 1, h - 2)
                        sm = row_sum(load(first, col), load(first, col + 1))
                        if left:
                            sl = row_sum(load(first, col - 1), load(first, col))
                        if right:
                            sr = row_sum(load(first, col + 1), load(first, col + 2))
                        acc = None
                        for y in range(first, last + 1):
                            m0, m1 = load(y + 1, col), load(y + 1, col + 1)
                            if left:
                                lv = load(y + 1, col - 1)
                                row = take(average(sl, lv, m0), average(sm, m0, m1))
                                sl = row_sum(lv, m0)
                            else:
                                row = average(sm, m0, m1)
                            sm = row_sum(m0, m1)
                            if right:
                                r = load(y + 1, col + 2)
                                row = take(row, average(sr, m1, r))
                                sr = row_sum(m1, r)
                            out = mx[n, :, j, q * v:q * v + v]
                            if y & 1:
                                if y != first:
                                    out[(y - 1) // 2] = take(acc, row)
                                acc = row
                            else:
                                acc = row if y == 0 else take(acc, row)
                                if y == h - 2:
                                    out[y // 2] = acc
    cl = torch.channels_last
    return avg.permute(0, 3, 1, 2).contiguous(memory_format=cl), \
        mx.permute(0, 3, 1, 2).contiguous(memory_format=cl)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,rows", [
    ((2, 16, 19, 17), 4), ((1, 16, 18, 20), 4), ((1, 32, 9, 8), 2), ((2, 16, 2, 2), 4),
    ((1, 16, 3, 5), 1), ((1, 16, 12, 3), 3), ((1, 32, 16, 16), 4)])
def test_the_kernels_rule_is_the_twin(shape, rows, dtype):
    """The kernel's walk (strips of max-pool rows with their halo rows,
    the two halves' column groups, the edges where a window leaves the
    averages), emulated, bit for bit the twin, NaN and infinities among the
    inputs; at strips of 1 to 4 rows, the kernel's being 2."""
    x = _input(shape, dtype, seed=sum(shape) + rows, specials=True)
    x[x.isfinite() & (torch.rand(x.shape, generator=torch.Generator().manual_seed(1)) < 0.05)] \
        = float("nan")
    for got, want in zip(_emulate(x, rows), adown_pool_plain(x)):
        # The CPU encodes a NaN narrowed to bf16 differently in its scalar
        # and vector conversions; the card's tests hold the NaN bits too.
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert _bit_equal(got[~nan], want[~nan])


def _fake_cuda(*tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda")
                      for t in tensors]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_fake_implementation_gives_the_cards_shapes_and_layout(dtype):
    """On fake CUDA tensors both results are channels_last, of the pooled
    shapes and x's dtype; on the CPU the twin's layout, x's."""
    x = _input((8, 256, 160, 160), dtype)
    mode, (fx,) = _fake_cuda(x)
    cuda_adown.reset_launches()
    with mode:
        got = adown_pool(fx)
        for g, s in zip(got, pooled_shapes(x.shape)):
            assert tuple(g.shape) == s and g.dtype == dtype and g.device.type == "cuda"
            assert g.is_contiguous(memory_format=torch.channels_last)
    assert cuda_adown.launches == 0
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        nchw = torch.empty(2, 16, 7, 9)
        got = torch.ops.vision_assist_tpu_torch.adown_pool(nchw)
        assert [tuple(g.shape) for g in got] == [(2, 8, 6, 8), (2, 8, 3, 4)]
        assert all(g.is_contiguous() for g in got)


def test_the_wrapper_raises_on_what_it_cannot_take():
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        adown_pool(torch.zeros(16, 8, 8))
    with pytest.raises(ValueError, match="even C"):
        adown_pool(torch.zeros(1, 15, 8, 8))
    with pytest.raises(ValueError, match="H, W >= 2"):
        adown_pool(torch.zeros(1, 16, 1, 8))


def test_on_fake_cuda_tensors_the_checks_run_before_a_launch():
    """The card's refusals, which the CPU's twin does not need: a layout
    other than channels_last, a dtype the kernel lacks, a half of the
    channels off the 16-byte pack (12 bf16 channels; 6 float32 ones)."""
    x = _input((2, 16, 8, 8))
    cuda_adown.reset_launches()
    mode, (fx,) = _fake_cuda(x)

    def card(c, dtype=torch.bfloat16, layout=torch.channels_last):
        return torch.empty(2, c, 8, 8, dtype=dtype, device="cuda", memory_format=layout)

    with mode:
        with pytest.raises(ValueError, match="not channels_last"):
            adown_pool(card(16, layout=torch.contiguous_format))
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            adown_pool(card(16, torch.float16))
        with pytest.raises(ValueError, match="8-channel packs"):
            adown_pool(card(24))
        with pytest.raises(ValueError, match="4-channel packs"):
            adown_pool(card(12, torch.float32))
        with pytest.raises(ValueError, match="at most 65535"):
            adown_pool(torch.empty(65536, 16, 2, 2, dtype=torch.bfloat16, device="cuda",
                                   memory_format=torch.channels_last))
        assert len(adown_pool(fx)) == 2
    assert cuda_adown.launches == 0


def test_no_launch_on_the_cpu():
    cuda_adown.reset_launches()
    adown_pool(_input((2, 32, 10, 10)))
    yolo.ADown(32, 32, dtype=torch.float32).eval()(_input((1, 32, 8, 8), torch.float32))
    assert cuda_adown.launches == 0


def _module(c: int = 32) -> yolo.ADown:
    torch.manual_seed(4)
    m = yolo.ADown(c, c, dtype=torch.float32)
    for bn in (m.cv1.bn, m.cv2.bn):
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
    return m


def test_train_mode_runs_the_twin_and_gradients_reach_x(monkeypatch):
    def refuse(x):
        raise AssertionError("train mode called the operator")

    monkeypatch.setattr(yolo, "adown_pool", refuse)
    m = _module().train()
    x = _input((2, 32, 9, 8), torch.float32, seed=5).requires_grad_(True)
    m(x).square().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("channels_last", [True, False])
def test_eval_forward_calls_the_operator_and_equals_the_chain(channels_last, monkeypatch):
    """``ADown`` in eval mode: one call of the operator, and the output of
    the chain it ran before (cv1 on the first half's view, cv2 on the max
    pool, concatenated) bit for bit."""
    calls = []

    def counted(x):
        calls.append(tuple(x.shape))
        return adown_pool(x)

    m = _module().eval()
    x = _input((2, 32, 10, 12), torch.float32, seed=6, channels_last=channels_last)
    with torch.no_grad():
        a, b = _chain(x)
        want = torch.cat([m.cv1(a), m.cv2(b)], 1)
        monkeypatch.setattr(yolo, "adown_pool", counted)
        got = m(x)
    assert calls == [(2, 32, 10, 12)]
    assert torch.equal(got, want)


def test_the_card_path_pools_with_eight_operators_and_no_average_pool():
    """One eval forward of YOLOv9e-seg traced on fake CUDA tensors (the
    served NHWC frame permuted): 8 ``adown_pool`` operators, no average
    pool; the max pools left are SPPELAN's three."""
    from test_torch_bn_act import _card_graph

    calls, _ = _card_graph("yolov9e-seg", 64, 2, train=False)
    assert calls["vision_assist_tpu_torch.adown_pool.default"] == 8
    assert not any("avg_pool" in c for c in calls), calls
    assert sum(n for c, n in calls.items() if "max_pool" in c) == 3


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(SERVED.values()), ids=list(SERVED))
def test_kernel_equals_its_twin_at_the_served_shapes(cuda, shape, dtype):
    """An ADown's input at imgsz 640 and batch 8, NaN, infinities and
    signed zeros among its values: one launch, both results bit for bit the
    twin's and the ATen chain's on the card."""
    x = _input((8, *shape), dtype, seed=sum(shape), specials=True, device=cuda)
    cuda_adown.reset_launches()
    got = adown_pool(x)
    torch.cuda.synchronize()
    assert cuda_adown.launches == 1
    for g, t, w in zip(got, adown_pool_plain(x), _chain(x)):
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert _bit_equal(g, t) and _bit_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ODD, ids=[f"{c}x{h}x{w}" for c, h, w in ODD])
def test_kernel_equals_its_twin_at_odd_sizes(cuda, shape, dtype):
    x = _input((3, *shape), dtype, seed=sum(shape) + 1, specials=True, device=cuda)
    got = adown_pool(x)
    torch.cuda.synchronize()
    for g, w in zip(got, _chain(x)):
        assert _bit_equal(g, w)


@pytest.mark.cuda
def test_the_card_refuses_what_the_kernel_cannot_take(cuda):
    x = _input((2, 16, 8, 8), device=cuda)
    cuda_adown.reset_launches()
    with pytest.raises(ValueError, match="not channels_last"):
        adown_pool(x.contiguous())
    with pytest.raises(ValueError, match="8-channel packs"):
        adown_pool(_input((2, 24, 8, 8), device=cuda))
    assert cuda_adown.launches == 0
