"""YOLO12-seg in the port (``models/yolo.py``) against the benchmark's plain
reference (``benchmark/reference/yolo12.py``), on the CPU.

The JAX package has no YOLO12, so the reference is the float32 model written
from the paper and Ultralytics' yaml, and the weights are the benchmark's
seeded draw (``benchmark/harness/weights.py::draw``, BatchNorm statistics
calibrated on walkway frames at the test's imgsz), loaded into both through
their Flax bridges.

* The four head outputs, as the benchmark's ``head_gap`` measures them (the
  largest |port - reference| over the reference's RMS, each output and
  frame) on two walkway frames, the inputs the draw's BatchNorm statistics
  are calibrated on: float32 within 1e-4 (the two sum their convolutions and
  the attention in another order; readings 2e-5 to 3e-5); bf16 within 0.2
  (bf16 keeps 8 bits of each activation, weight and attention probability
  through some 200 layers at x; readings 0.05 to 0.07, where the reference
  with float8 operands, the benchmark's control, reads 0.63 to 0.91).
* The bridge names every leaf, gamma included, and takes each once.
* The parameter count of the nc=80 detector against the published one.
* The area split is by row strips; the residual scale gamma is applied.
* The C3k2 ``c3k`` rule of Ultralytics' ``parse_model`` at scales m, l, x,
  held by yolo11m-seg's published parameter count.
"""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from benchmark.harness.check import head_gap
from benchmark.harness.frames import walkway_pool
from benchmark.harness.weights import draw
from benchmark.reference import yolo12 as ref12
from benchmark.reference.segment import ExactFloat32
from vision_assist_tpu_torch.models import yolo
from vision_assist_tpu_torch.models.yolo import (
    A2C2f,
    AAttn,
    YoloSeg,
    convert_flax_variables,
    flax_leaves,
    to_flax_variables,
)
from vision_assist_tpu_torch.ops import attention

torch.set_num_threads(2)

SEED = 2 ** 31 + 20
F32_LIMIT = 1e-4
BF16_LIMIT = 0.2
_trees: dict = {}


def _config(arch: str, imgsz: int) -> dict:
    return {"arch": arch, "imgsz": imgsz, "num_classes": 1, "reg_max": 16,
            "num_mask_coeffs": 32}


def _tree(arch: str, imgsz: int) -> dict:
    key = arch, imgsz
    if key not in _trees:
        _trees[key] = draw(ref12, _config(arch, imgsz), SEED, "cpu")
    return _trees[key]


def _flat(out) -> list[list[torch.Tensor]]:
    """Each frame's four head outputs, flattened as the benchmark's check does."""
    heads = [torch.cat([t.flatten(2) for t in getattr(out, h)], 2).float()
             for h in ("box_logits", "cls_logits", "coeffs")] + [out.protos.float()]
    return [[h[i] for h in heads] for i in range(heads[0].shape[0])]


@pytest.mark.parametrize("arch,imgsz,dtype,limit", [
    ("yolo12x-seg", 64, torch.float32, F32_LIMIT),
    ("yolo12x-seg", 96, torch.float32, F32_LIMIT),
    ("yolo12n-seg", 128, torch.float32, F32_LIMIT),
    ("yolo12x-seg", 64, torch.bfloat16, BF16_LIMIT),
    ("yolo12x-seg", 96, torch.bfloat16, BF16_LIMIT),
    ("yolo12n-seg", 128, torch.bfloat16, BF16_LIMIT),
])
def test_port_equals_the_reference(arch, imgsz, dtype, limit):
    tree = _tree(arch, imgsz)
    config = _config(arch, imgsz)
    ref = ref12.build_model(config)
    ref12.load_flax_variables(ref, tree)
    model = YoloSeg(arch, dtype=dtype)
    model.load_state_dict(convert_flax_variables(tree, model))
    frames = walkway_pool(2, imgsz, imgsz, seed=imgsz)
    images = torch.from_numpy(frames[..., ::-1].copy()).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), ExactFloat32():
        want = ref.eval()(images)
        got = model.eval()(images)
    gap = head_gap(_flat(got), _flat(want))
    assert gap <= limit, gap
    assert all(torch.isfinite(t).all() for frame in _flat(got) for t in frame)


def test_yolo12x_is_the_published_architecture():
    with torch.device("meta"):
        model = YoloSeg("yolo12x-seg")
    attns = [m for m in model.modules() if isinstance(m, AAttn)]
    assert [a.area for a in attns] == [4] * 8 + [1] * 8
    assert {(a.nh, a.head_dim) for a in attns} == {(12, 32)}
    assert {tuple(a.pe.conv.weight.shape) for a in attns} == {(384, 1, 7, 7)}
    blocks = [m for m in model.modules() if isinstance(m, yolo.ABlock)]
    assert {b.mlp[0].conv.out_channels for b in blocks} == {460}
    gammas = [m for m in model.modules() if isinstance(m, A2C2f) and m.gamma is not None]
    assert gammas == [model.backbone[6], model.backbone[8]]
    assert model.backbone[1].conv.groups == 2 and model.backbone[3].conv.groups == 4
    c3k2 = [m for m in model.modules() if isinstance(m, yolo.C3k2)]
    assert len(c3k2) == 3 and all(isinstance(u, yolo.C3) for c in c3k2 for u in c.m)
    assert not any(isinstance(m, (yolo.SPPF, yolo.C2PSA)) for m in model.modules())


def _count(model, detect_only: bool) -> int:
    total = sum(p.numel() for p in model.parameters())
    if detect_only:
        total -= sum(p.numel() for h in model.heads for p in h[2].parameters())
        total -= sum(p.numel() for p in model.proto.parameters())
    return total


def test_detector_parameters_against_the_published_count():
    """YOLO12x at 80 classes, without the mask branches and Proto: 58,132,496
    parameters. The published 59.1 M (the yaml's summary line: 59,210,784,
    the DFL's 16 fixed weights included) is this model with its two
    grouped stride-2 convolutions dense: their groups save exactly the
    1,078,272 parameters between the two."""
    with torch.device("meta"):
        model = YoloSeg("yolo12x-seg", num_classes=80, dtype=torch.float32)
    count = _count(model, detect_only=True)
    grouped = [m.conv for m in model.backbone[:4] if isinstance(m, yolo.ConvBNAct)
               and m.conv.groups > 1]
    saved = sum(c.weight.numel() * (c.groups - 1) for c in grouped)
    assert count == 58_132_496
    assert saved == 1_078_272
    assert count + saved + 16 == 59_210_784
    assert abs(count + saved - 59.1e6) / 59.1e6 < 0.01
    with torch.device("meta"):
        nano = YoloSeg("yolo12n-seg", num_classes=80, dtype=torch.float32)
    assert abs(_count(nano, detect_only=True) - 2.6e6) / 2.6e6 < 0.015


def test_yolo11m_counts_the_published_parameters():
    """YOLO11m-seg, 80 classes: 22.4 M parameters
    (docs.ultralytics.com/tasks/segment), with c3k in every C3k2 at m as
    Ultralytics' parse_model sets it (the JAX package leaves it off in five
    of them: 20.0 M)."""
    with torch.device("meta"):
        model = YoloSeg("yolo11m-seg", num_classes=80, dtype=torch.float32)
    assert abs(_count(model, detect_only=False) - 22.4e6) / 22.4e6 < 0.01
    for arch, c3k in [("yolo11n-seg", False), ("yolo11s-seg", False), ("yolo11m-seg", True),
                      ("yolo12n-seg", False), ("yolo12s-seg", False), ("yolo12m-seg", True)]:
        with torch.device("meta"):
            m = YoloSeg(arch)
        for block in (m.backbone[2], m.backbone[4]):
            assert all(isinstance(u, yolo.C3) == c3k for u in block.m), (arch, block)


@pytest.mark.parametrize("arch", ["yolo12n-seg", "yolo12x-seg"])
def test_bridge_takes_every_leaf_once(arch):
    with torch.device("meta"):
        shapes = YoloSeg(arch, dtype=torch.float32)
    leaves = flax_leaves(shapes)
    paths = [p for _, p, _ in leaves]
    assert len(paths) == len(set(paths))
    with torch.device("meta"):
        reference = ref12.YoloSeg12(arch)
    assert paths == [p for _, p, _ in ref12.flax_leaves(reference)]
    gammas = [p for p in paths if p[-1] == "gamma"]
    assert gammas == ([("params", "A2C2f_0", "gamma"), ("params", "A2C2f_1", "gamma")]
                      if arch == "yolo12x-seg" else [])
    tree = _tree(arch, 64)
    model = YoloSeg(arch, dtype=torch.float32)
    state = convert_flax_variables(tree, model)
    model.load_state_dict(state)
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
    tree = dict(tree, params=dict(tree["params"], Extra_0={"gamma": np.ones(4, np.float32)}))
    with pytest.raises(ValueError, match="not consumed"):
        convert_flax_variables(tree, YoloSeg(arch, dtype=torch.float32))


def test_bridge_refuses_a_missing_gamma():
    tree = _tree("yolo12x-seg", 64)
    params = dict(tree["params"])
    params["A2C2f_1"] = {k: v for k, v in params["A2C2f_1"].items() if k != "gamma"}
    with pytest.raises(ValueError, match="A2C2f_1/gamma is missing"):
        convert_flax_variables(dict(tree, params=params), YoloSeg("yolo12x-seg"))


def _attn(area: int, seed: int = 3) -> AAttn:
    torch.manual_seed(seed)
    m = AAttn(64, 2, area, dtype=torch.float32).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
        for bn in (m.qkv.bn, m.proj.bn, m.pe.bn):
            bn.running_var.uniform_(0.5, 1.5)
            bn.running_mean.normal_()
    return m


def _by_strips(m: AAttn, x: torch.Tensor, strips: list) -> torch.Tensor:
    """``m``'s output with its attention computed on each token set of
    ``strips`` ((rows, cols) index arrays) alone, by explicit matmuls."""
    b, c, h, w = x.shape
    qkv = m.qkv(x)
    out = torch.zeros(b, c, h, w)
    for rows, cols in strips:
        t = qkv[:, :, rows, cols].reshape(b, m.nh, 3, m.head_dim, -1)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]                  # (B, nh, hd, T)
        p = torch.softmax(q.transpose(-2, -1) @ k / math.sqrt(m.head_dim), dim=-1)
        out[:, :, rows, cols] = (v @ p.transpose(-2, -1)).reshape(b, c, -1)
    v_all = qkv.reshape(b, m.nh, 3, m.head_dim, h, w)[:, :, 2].reshape(b, c, h, w)
    return m.proj(out + m.pe(v_all))


def test_areas_are_row_strips():
    """At area 4 on an 8x8 grid each area is two rows: the block equals
    attention on each strip of rows alone, not on strips of columns."""
    m = _attn(4)
    x = torch.randn(2, 64, 8, 8, generator=torch.Generator().manual_seed(1))
    grid_r, grid_c = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    rows = [(grid_r[2 * a:2 * a + 2].flatten(), grid_c[2 * a:2 * a + 2].flatten())
            for a in range(4)]
    cols = [(grid_r[:, 2 * a:2 * a + 2].T.flatten(), grid_c[:, 2 * a:2 * a + 2].T.flatten())
            for a in range(4)]
    with torch.no_grad():
        got = m(x)
        by_rows, by_cols = _by_strips(m, x, rows), _by_strips(m, x, cols)
        full = _by_strips(m, x, [(grid_r.flatten(), grid_c.flatten())])
    scale = float(by_rows.abs().max())
    assert float((got - by_rows).abs().max()) <= 1e-5 * scale
    assert float((got - by_cols).abs().max()) > 1e-2 * scale
    assert float((got - full).abs().max()) > 1e-2 * scale
    with torch.no_grad():
        assert torch.allclose(_attn(1)(x), full, rtol=0, atol=1e-5 * scale)


def test_gamma_scales_the_residual():
    block = A2C2f(64, 64, 1, a2=True, area=1, residual=True, mlp_ratio=1.2,
                  dtype=torch.float32).eval()
    x = torch.randn(1, 64, 4, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        block.gamma.zero_()
        assert torch.equal(block(x), x)
        block.gamma.fill_(1.0)
        y = block.cv2(torch.cat([block.cv1(x), block.m[0](block.cv1(x))], dim=1))
        assert torch.allclose(block(x), x + y)
    assert A2C2f(64, 64, 1, a2=False, residual=True, dtype=torch.float32).gamma is None


def test_the_attention_kernel_is_pinned():
    from torch.nn.attention import SDPBackend

    def q(device, dtype):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype)

    assert attention.sdpa_backend(q("cpu", torch.bfloat16)) == SDPBackend.MATH
    assert attention.sdpa_backend(q("cuda", torch.bfloat16)) == SDPBackend.FLASH_ATTENTION
    assert attention.sdpa_backend(q("cuda", torch.float32)) == SDPBackend.EFFICIENT_ATTENTION


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_attention_equals_the_math_path_on_the_card(cuda, monkeypatch):
    """The served block's FlashAttention call against the same block on the
    math path, both bf16 on the card, at P4's served shape (8 frames, 40x40,
    4 areas, 12 heads): within bf16's rounding of P before P.V."""
    from torch.nn.attention import SDPBackend

    torch.manual_seed(0)
    m = AAttn(384, 12, 4).eval().to(cuda)
    x = torch.randn(8, 384, 40, 40, device=cuda, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = m(x).float()
        monkeypatch.setattr(yolo, "sdpa_backend", lambda q: SDPBackend.MATH)
        want = m(x).float()
    rms = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) <= 0.05 * rms
