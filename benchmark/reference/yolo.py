"""Plain float32 YOLOv8n-seg / YOLO11n-seg forward, the benchmark's own.

A configuration names its reference module by its key ``"reference"``
(this one, ``yolo``, where it names none). The harness calls four functions
of the module: ``build_model(config)``, the float32 model, whose forward
returns ``Outputs``; ``flax_leaves(model)``, its Flax leaves in creation
order; ``load_flax_variables(model, variables)``; ``set_quant(model,
quant)``. A new architecture brings a module of its own with the same four,
and may import blocks from this one. A per-pixel head's model (a
configuration with ``"head": "semantic"``) returns an object with a field
``logits`` instead (``reference/segment.py``), and its ``flax_leaves`` may
give the layouts ``"dense"`` and ``"layer_norm"`` (``harness/weights.py``).

A frozen copy of the serving forward of the port's ``models/yolo.py``: the
same blocks, channel and depth scaling and Flax weight layout, but every
convolution, BatchNorm and matmul in float32 (the caller turns TF32 off), no
training path and no compute dtype. Departures from the published
Ultralytics models are the port's own and are kept: Flax "SAME" padding on
stride-2 convolutions (the odd pixel on the bottom/right), BatchNorm eps
1e-3, one class.

``quant``: an optional function applied to every convolution's and matmul's
inputs and weights. ``None`` is the reference; the precision control passes
a rounding to a lower precision (``benchmark/control.py``'s ``fake_fp8``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class YoloScale:
    depth: float
    width: float
    max_channels: int


SCALES = {"n": YoloScale(depth=1 / 3, width=1 / 4, max_channels=1024)}
SCALES_11 = {"n": YoloScale(depth=1 / 2, width=1 / 4, max_channels=1024)}


def _q(quant, x):
    return x if quant is None else quant(x)


def _round_ch(c: float) -> int:
    return max(int(round(c)), 1)


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" padding: the odd pixel goes to the bottom/right."""
    if k == 1 and s == 1:
        return x
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Conv(nn.Conv2d):
    """A 1x1 head convolution with a bias (Flax "Conv")."""

    quant = None

    def forward(self, x):
        return F.conv2d(_q(self.quant, x), _q(self.quant, self.weight), self.bias)


class ConvBNAct(nn.Module):
    def __init__(self, c_in, c_out, kernel=1, stride=1, groups=1, act=True):
        super().__init__()
        self.kernel, self.stride, self.act = kernel, stride, act
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)
        self.quant = None

    def forward(self, x):
        c = self.conv
        y = F.conv2d(_pad_same(_q(self.quant, x), self.kernel, self.stride),
                     _q(self.quant, c.weight), None, c.stride, 0, 1, c.groups)
        y = self.bn(y)
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c_in, features, shortcut=True, expansion=0.5, kernels=(3, 3)):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, hidden, kernels[0])
        self.cv2 = ConvBNAct(hidden, features, kernels[1])
        self.add = shortcut and c_in == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c_in, features, n=1, shortcut=False, expansion=0.5):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1)
        self.m = nn.ModuleList(Bottleneck(hidden, hidden, shortcut, 1.0, (3, 3))
                               for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1)

    def forward(self, x):
        outs = list(torch.chunk(self.cv1(x), 2, dim=1))
        for m in self.m:
            outs.append(m(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class C3(nn.Module):
    def __init__(self, c_in, features, n=1, shortcut=True, expansion=0.5,
                 kernels=(1, 3)):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, hidden, 1)
        self.m = nn.ModuleList(Bottleneck(hidden, hidden, shortcut, 1.0, kernels)
                               for _ in range(n))
        self.cv2 = ConvBNAct(c_in, hidden, 1)
        self.cv3 = ConvBNAct(2 * hidden, features, 1)

    def forward(self, x):
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    def __init__(self, c_in, features, n=1, c3k=False, shortcut=True, expansion=0.5):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1)
        self.m = nn.ModuleList(
            C3(hidden, hidden, 2, shortcut, kernels=(3, 3)) if c3k
            else Bottleneck(hidden, hidden, shortcut, 0.5, (3, 3)) for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1)

    def forward(self, x):
        outs = list(torch.chunk(self.cv1(x), 2, dim=1))
        for m in self.m:
            outs.append(m(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    def __init__(self, c_in, features, pool=5):
        super().__init__()
        hidden = c_in // 2
        self.pool = pool
        self.cv1 = ConvBNAct(c_in, hidden, 1)
        self.cv2 = ConvBNAct(4 * hidden, features, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.pool, stride=1, padding=self.pool // 2))
        return self.cv2(torch.cat(ys, dim=1))


class Attention(nn.Module):
    """YOLO11 PSA attention: heads over the spatial grid, a depthwise
    positional conv on v; qkv channels split per head as (nh, 2*kd + hd)."""

    def __init__(self, dim, num_heads, attn_ratio=0.5):
        super().__init__()
        self.nh = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        qkv_dim = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = ConvBNAct(dim, qkv_dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, groups=dim, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.quant = None

    def forward(self, x):
        b, _, h, w = x.shape
        nh, kd, hd = self.nh, self.key_dim, self.head_dim
        qkv = self.qkv(x).reshape(b, nh, 2 * kd + hd, h * w)
        q, k, v = torch.split(qkv, [kd, kd, hd], dim=2)
        qn = self.quant
        attn = torch.einsum("bhdq,bhdk->bhqk", _q(qn, q), _q(qn, k))
        attn = torch.softmax(attn * (kd ** -0.5), dim=-1)
        out = torch.einsum("bhqk,bhdk->bhdq", _q(qn, attn), _q(qn, v))
        out = out.reshape(b, nh * hd, h, w)
        return self.proj(out + self.pe(v.reshape(b, nh * hd, h, w)))


class PSABlock(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.attn = Attention(dim, num_heads)
        self.ffn1 = ConvBNAct(dim, dim * 2, 1)
        self.ffn2 = ConvBNAct(dim * 2, dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    def __init__(self, c_in, features, n=1):
        super().__init__()
        hidden = features // 2
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1)
        self.m = nn.ModuleList(PSABlock(hidden, max(1, hidden // 64)) for _ in range(n))
        self.cv2 = ConvBNAct(2 * hidden, features, 1)

    def forward(self, x):
        a, b = torch.chunk(self.cv1(x), 2, dim=1)
        for m in self.m:
            b = m(b)
        return self.cv2(torch.cat([a, b], dim=1))


class Proto(nn.Module):
    def __init__(self, c_in, hidden, out):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, hidden, 3)
        self.up = nn.ConvTranspose2d(hidden, hidden, 2, 2, bias=True)
        self.cv2 = ConvBNAct(hidden, hidden, 3)
        self.cv3 = ConvBNAct(hidden, out, 1)
        self.quant = None

    def forward(self, x):
        x = self.cv1(x)
        x = F.conv_transpose2d(_q(self.quant, x), _q(self.quant, self.up.weight),
                               self.up.bias, self.up.stride)
        return self.cv3(self.cv2(x))


@dataclasses.dataclass
class Outputs:
    box_logits: list
    cls_logits: list
    coeffs: list
    protos: torch.Tensor
    strides: tuple = (8, 16, 32)


class YoloSeg(nn.Module):
    """images (B, 3, H, W) float32 in [0, 1] -> per-level head outputs."""

    def __init__(self, arch: str, num_classes: int = 1, reg_max: int = 16,
                 num_masks: int = 32):
        super().__init__()
        if arch not in ("yolov8n-seg", "yolo11n-seg"):
            raise ValueError(f"the reference has no {arch}")
        v11 = arch == "yolo11n-seg"
        s = (SCALES_11 if v11 else SCALES)["n"]

        def ch(c):
            return _round_ch(min(c, s.max_channels) * s.width)

        def depth(n):
            return max(int(round(n * s.depth)), 1)

        if v11:
            self.backbone = nn.ModuleList([
                ConvBNAct(3, ch(64), 3, 2), ConvBNAct(ch(64), ch(128), 3, 2),
                C3k2(ch(128), ch(256), depth(2), False, True, 0.25),
                ConvBNAct(ch(256), ch(256), 3, 2),
                C3k2(ch(256), ch(512), depth(2), False, True, 0.25),
                ConvBNAct(ch(512), ch(512), 3, 2),
                C3k2(ch(512), ch(512), depth(2), True, True),
                ConvBNAct(ch(512), ch(1024), 3, 2),
                C3k2(ch(1024), ch(1024), depth(2), True, True),
                SPPF(ch(1024), ch(1024), 5), C2PSA(ch(1024), ch(1024), depth(2))])
            c_p3, c_p4 = ch(512), ch(512)

            def block(ci, c, n, sc, c3k=False):
                return C3k2(ci, c, depth(n), c3k=c3k, shortcut=True)
            neck_n = 2
        else:
            self.backbone = nn.ModuleList([
                ConvBNAct(3, ch(64), 3, 2), ConvBNAct(ch(64), ch(128), 3, 2),
                C2f(ch(128), ch(128), depth(3), True),
                ConvBNAct(ch(128), ch(256), 3, 2), C2f(ch(256), ch(256), depth(6), True),
                ConvBNAct(ch(256), ch(512), 3, 2), C2f(ch(512), ch(512), depth(6), True),
                ConvBNAct(ch(512), ch(1024), 3, 2), C2f(ch(1024), ch(1024), depth(3), True),
                SPPF(ch(1024), ch(1024), 5)])
            c_p3, c_p4 = ch(256), ch(512)

            def block(ci, c, n, sc, c3k=False):
                return C2f(ci, c, depth(n), shortcut=sc)
            neck_n = 3
        c_p5 = ch(1024)
        self.h1 = block(c_p5 + c_p4, ch(512), neck_n, False)
        self.n3 = block(ch(512) + c_p3, ch(256), neck_n, False)
        self.d1 = ConvBNAct(ch(256), ch(256), 3, 2)
        self.n4 = block(ch(256) + ch(512), ch(512), neck_n, False)
        self.d2 = ConvBNAct(ch(512), ch(512), 3, 2)
        self.n5 = block(ch(512) + c_p5, ch(1024), neck_n, False, c3k=True)

        feats = [ch(256), ch(512), ch(1024)]
        c_box = max(16, feats[0] // 4, reg_max * 4)
        c_cls = max(feats[0], min(num_classes, 100))
        c_m = max(feats[0] // 4, num_masks)
        heads = []
        for f in feats:
            box = [ConvBNAct(f, c_box, 3), ConvBNAct(c_box, c_box, 3),
                   Conv(c_box, 4 * reg_max, 1)]
            if v11:
                cls = [ConvBNAct(f, f, 3, groups=f), ConvBNAct(f, c_cls, 1),
                       ConvBNAct(c_cls, c_cls, 3, groups=c_cls), ConvBNAct(c_cls, c_cls, 1)]
            else:
                cls = [ConvBNAct(f, c_cls, 3), ConvBNAct(c_cls, c_cls, 3)]
            cls.append(Conv(c_cls, num_classes, 1))
            mask = [ConvBNAct(f, c_m, 3), ConvBNAct(c_m, c_m, 3), Conv(c_m, num_masks, 1)]
            heads.append(nn.ModuleList(
                [nn.ModuleList(box), nn.ModuleList(cls), nn.ModuleList(mask)]))
        self.heads = nn.ModuleList(heads)
        self.proto = Proto(ch(256), ch(256), num_masks)
        self._p3_at, self._p4_at = 4, 6

    def forward(self, images: torch.Tensor) -> Outputs:
        x = images
        for i, layer in enumerate(self.backbone):
            x = layer(x)
            if i == self._p3_at:
                p3 = x
            elif i == self._p4_at:
                p4 = x
        p5 = x

        def up(z):
            return F.interpolate(z, scale_factor=2, mode="nearest")

        h1 = self.h1(torch.cat([up(p5), p4], dim=1))
        n3 = self.n3(torch.cat([up(h1), p3], dim=1))
        n4 = self.n4(torch.cat([self.d1(n3), h1], dim=1))
        n5 = self.n5(torch.cat([self.d2(n4), p5], dim=1))
        branches = [[], [], []]
        for f, head in zip([n3, n4, n5], self.heads):
            for out, branch in zip(branches, head):
                y = f
                for layer in branch:
                    y = layer(y)
                out.append(y)
        return Outputs(branches[0], branches[1], branches[2], self.proto(n3))


def build_model(config: dict) -> YoloSeg:
    """The float32 model of a configuration."""
    return YoloSeg(config["arch"], config["num_classes"], config["reg_max"],
                   config["num_mask_coeffs"])


def set_quant(model: nn.Module, quant) -> None:
    """Apply ``quant`` to every convolution's and matmul's operands (None:
    the reference itself)."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant


# --- Flax weight layout -------------------------------------------------------


def _flax_kind(child: nn.Module) -> str:
    if isinstance(child, nn.Conv2d):
        return "Conv"
    if isinstance(child, nn.BatchNorm2d):
        return "BatchNorm"
    if isinstance(child, nn.ConvTranspose2d):
        return "ConvTranspose"
    return type(child).__name__


def _flax_children(module: nn.Module):
    """(Flax name, child) in creation order; containers are transparent."""
    counts: dict[str, int] = {}
    out = []

    def visit(m):
        for child in m.children():
            if isinstance(child, nn.ModuleList):
                visit(child)
                continue
            kind = _flax_kind(child)
            n = counts.get(kind, 0)
            counts[kind] = n + 1
            out.append((f"{kind}_{n}", child))

    visit(module)
    return out


def flax_leaves(model: nn.Module) -> list[tuple[str, tuple[str, ...], str]]:
    """(``state_dict`` key, Flax path, layout) of every tensor that has a Flax
    leaf, in the Flax module's creation order. Layout "conv": a kernel HWIO
    in Flax, OIHW here; "conv_transpose": (kh, kw, in, out) in Flax, (in,
    out, kh, kw) with both spatial axes flipped here; "same": one array."""
    names = {id(m): n for n, m in model.named_modules()}
    out = []

    def walk(module, path):
        for fname, child in _flax_children(module):
            p, s = ("params",) + path + (fname,), ("batch_stats",) + path + (fname,)
            name = names[id(child)]
            if isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)):
                layout = "conv" if isinstance(child, nn.Conv2d) else "conv_transpose"
                out.append((f"{name}.weight", p + ("kernel",), layout))
                if child.bias is not None:
                    out.append((f"{name}.bias", p + ("bias",), "same"))
            elif isinstance(child, nn.BatchNorm2d):
                out.extend([(f"{name}.weight", p + ("scale",), "same"),
                            (f"{name}.bias", p + ("bias",), "same"),
                            (f"{name}.running_mean", s + ("mean",), "same"),
                            (f"{name}.running_var", s + ("var",), "same")])
            else:
                walk(child, path + (fname,))

    walk(model, ())
    return out


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` from a Flax ``{"params", "batch_stats"}`` tree of numpy
    arrays: kernels HWIO -> OIHW, transposed kernels (kh, kw, in, out) ->
    (in, out, kh, kw) with both spatial axes flipped. Raises on a missing,
    surplus or misshapen leaf."""
    used = set()
    state = {}

    def take(path):
        node = variables
        for k in path:
            if k not in node:
                raise ValueError(f"flax leaf {'/'.join(path)} is missing")
            node = node[k]
        used.add(path)
        return np.asarray(node, np.float32)

    for key, path, layout in flax_leaves(model):
        value = take(path)
        if layout == "conv":
            value = value.transpose(3, 2, 0, 1)
        elif layout == "conv_transpose":
            value = value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        state[key] = value

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path

    left = [p for p in leaves(variables) if p not in used]
    if left:
        raise ValueError(f"{len(left)} flax leaves not used, e.g. {left[:3]}")
    want = model.state_dict()
    for key, value in state.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: {value.shape} != {tuple(want[key].shape)}")
    missing = [k for k in want if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"model tensors not filled: {missing[:5]}")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=False)
