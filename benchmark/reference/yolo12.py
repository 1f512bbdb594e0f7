"""Plain float32 YOLO12-seg forward, the benchmark's reference for the
configurations that name ``"reference": "yolo12"``.

Sources: Tian, Ye and Doermann, "YOLOv12: Attention-Centric Real-Time Object
Detectors", arXiv:2502.12524; Ultralytics
``ultralytics/cfg/models/12/yolo12-seg.yaml``, with ``AAttn``, ``ABlock`` and
``A2C2f`` in ``ultralytics/nn/modules/block.py`` and the scale rules of
``ultralytics/nn/tasks.py::parse_model`` (every C3k2 takes ``c3k`` at scales
m, l and x; an A2C2f with attention takes a residual scale and an MLP ratio of
1.2 at l and x, 2.0 elsewhere).

Written from those sources, not from the program: every convolution,
BatchNorm and matmul in float32 (the caller turns TF32 off), the attention
as explicit matmuls and a softmax over each area. The shared blocks
(ConvBNAct, C3, C3k2, Proto, the head's 1x1 convolutions) are
``reference/yolo.py``'s.

Departures from Ultralytics, each the program's own:

* stride-2 convolutions pad Flax "SAME" (the odd pixel on the bottom/right),
  not ``p=1``;
* one class, the walkway;
* BatchNorm eps 1e-3;
* leaves named as Flax names them (``A2C2f_0/ABlock_3/AAttn_0/ConvBNAct_2``),
  the residual scale the leaf ``A2C2f_k/gamma``, after the block's children.

``quant``: applied to every convolution's and matmul's operands, the two
attention products included (``None`` is the reference; the precision
control passes a rounding to float8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import yolo
from benchmark.reference.yolo import C3, C3k2, Conv, ConvBNAct, Outputs, Proto, _q

# (depth, width, max channels) of the yaml's scales.
SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)}


class AAttn(nn.Module):
    """Area attention: the grid's tokens in row-major order, cut into
    ``area`` equal runs, each attending within itself; heads of 32
    channels, qkv split per head as [q | k | v]; ``proj(out + pe(v))``."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area, self.nh, self.hd = area, num_heads, dim // num_heads
        self.qkv = ConvBNAct(dim, 3 * dim, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 7, groups=dim, act=False)
        self.quant = None

    def forward(self, x):
        b, c, h, w = x.shape
        n, nh, hd, a = h * w, self.nh, self.hd, self.area
        tokens = self.qkv(x).flatten(2).transpose(1, 2)                  # (B, N, 3C)
        qkv = tokens.reshape(b * a, n // a, nh, 3 * hd).permute(0, 2, 3, 1)
        q, k, v = qkv.split([hd, hd, hd], dim=2)                           # (B', nh, hd, T)
        qn = self.quant
        scores = torch.matmul(_q(qn, q).transpose(-2, -1), _q(qn, k)) * hd ** -0.5
        p = torch.softmax(scores, dim=-1)                                  # (B', nh, T, T)
        out = torch.matmul(_q(qn, v), _q(qn, p).transpose(-2, -1))        # (B', nh, hd, T)

        def grid(t):
            return t.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)

        return self.proj(grid(out) + self.pe(grid(v)))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleList([ConvBNAct(dim, hidden, 1),
                                  ConvBNAct(hidden, dim, 1, act=False)])

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp[1](self.mlp[0](x))


class A2C2f(nn.Module):
    """``y = [cv1(x)]``; n units on the last entry (two ABlocks with
    ``a2``, else a C3k of two 3x3 bottlenecks); ``cv2(cat(y))``, and with
    ``residual`` ``x + gamma * cv2(...)``."""

    def __init__(self, c_in, features, n=1, a2=True, area=1, residual=False,
                 mlp_ratio=2.0):
        super().__init__()
        hidden = int(features * 0.5)
        self.cv1 = ConvBNAct(c_in, hidden, 1)
        units = []
        for _ in range(n):
            if a2:
                units += [ABlock(hidden, hidden // 32, mlp_ratio, area) for _ in range(2)]
            else:
                units.append(C3(hidden, hidden, 2, True, kernels=(3, 3)))
        self.m = nn.ModuleList(units)
        self.unit = 2 if a2 else 1
        self.cv2 = ConvBNAct((1 + n) * hidden, features, 1)
        self.gamma = nn.Parameter(torch.full((features,), 0.01)) if a2 and residual else None

    def forward(self, x):
        ys = [self.cv1(x)]
        for i in range(0, len(self.m), self.unit):
            y = ys[-1]
            for m in self.m[i:i + self.unit]:
                y = m(y)
            ys.append(y)
        y = self.cv2(torch.cat(ys, dim=1))
        return y if self.gamma is None else x + self.gamma.view(1, -1, 1, 1) * y


class YoloSeg12(nn.Module):
    """images (B, 3, H, W) float32 in [0, 1] -> per-level head outputs."""

    def __init__(self, arch: str, num_classes: int = 1, reg_max: int = 16,
                 num_masks: int = 32):
        super().__init__()
        letter = arch.removeprefix("yolo12").removesuffix("-seg")
        if not arch.startswith("yolo12") or letter not in SCALES:
            raise ValueError(f"the YOLO12 reference has no {arch}")
        d, wd, cap = SCALES[letter]
        c3k, residual = letter in "mlx", letter in "lx"
        mlp = 1.2 if residual else 2.0

        def ch(c):
            return max(int(round(min(c, cap) * wd)), 1)

        def depth(n):
            return max(int(round(n * d)), 1)

        self.backbone = nn.ModuleList([
            ConvBNAct(3, ch(64), 3, 2),
            ConvBNAct(ch(64), ch(128), 3, 2, groups=2),
            C3k2(ch(128), ch(256), depth(2), c3k, True, 0.25),
            ConvBNAct(ch(256), ch(256), 3, 2, groups=4),
            C3k2(ch(256), ch(512), depth(2), c3k, True, 0.25),              # P3
            ConvBNAct(ch(512), ch(512), 3, 2),
            A2C2f(ch(512), ch(512), depth(4), True, 4, residual, mlp),     # P4
            ConvBNAct(ch(512), ch(1024), 3, 2),
            A2C2f(ch(1024), ch(1024), depth(4), True, 1, residual, mlp)])  # P5
        c_p3, c_p4, c_p5 = ch(512), ch(512), ch(1024)
        self.h1 = A2C2f(c_p5 + c_p4, ch(512), depth(2), False)
        self.n3 = A2C2f(ch(512) + c_p3, ch(256), depth(2), False)
        self.d1 = ConvBNAct(ch(256), ch(256), 3, 2)
        self.n4 = A2C2f(ch(256) + ch(512), ch(512), depth(2), False)
        self.d2 = ConvBNAct(ch(512), ch(512), 3, 2)
        self.n5 = C3k2(ch(512) + c_p5, ch(1024), depth(2), True, True)

        feats = [ch(256), ch(512), ch(1024)]
        c_box = max(16, feats[0] // 4, reg_max * 4)
        c_cls = max(feats[0], min(num_classes, 100))
        c_m = max(feats[0] // 4, num_masks)
        heads = []
        for f in feats:
            box = [ConvBNAct(f, c_box, 3), ConvBNAct(c_box, c_box, 3),
                   Conv(c_box, 4 * reg_max, 1)]
            cls = [ConvBNAct(f, f, 3, groups=f), ConvBNAct(f, c_cls, 1),
                   ConvBNAct(c_cls, c_cls, 3, groups=c_cls), ConvBNAct(c_cls, c_cls, 1),
                   Conv(c_cls, num_classes, 1)]
            mask = [ConvBNAct(f, c_m, 3), ConvBNAct(c_m, c_m, 3), Conv(c_m, num_masks, 1)]
            heads.append(nn.ModuleList(
                [nn.ModuleList(box), nn.ModuleList(cls), nn.ModuleList(mask)]))
        self.heads = nn.ModuleList(heads)
        self.proto = Proto(ch(256), ch(256), num_masks)

    def forward(self, images: torch.Tensor) -> Outputs:
        x = images
        for i, layer in enumerate(self.backbone):
            x = layer(x)
            if i == 4:
                p3 = x
            elif i == 6:
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


def build_model(config: dict) -> YoloSeg12:
    """The float32 model of a configuration."""
    return YoloSeg12(config["arch"], config["num_classes"], config["reg_max"],
                     config["num_mask_coeffs"])


set_quant = yolo.set_quant


def flax_leaves(model: nn.Module) -> list[tuple[str, tuple[str, ...], str]]:
    """(``state_dict`` key, Flax path, layout) of every tensor that has a Flax
    leaf, in creation order, as ``reference/yolo.py::flax_leaves`` gives
    them; after a block's children, the parameter it holds itself (A2C2f's
    ``gamma``), layout "same"."""
    names = {id(m): n for n, m in model.named_modules()}
    out = []

    def walk(module, path):
        for fname, child in yolo._flax_children(module):
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
                for pname, _ in child.named_parameters(recurse=False):
                    out.append((f"{name}.{pname}", p + (pname,), "same"))

    walk(model, ())
    return out


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` from a Flax ``{"params", "batch_stats"}`` tree of numpy
    arrays, as ``reference/yolo.py`` does, gamma leaves included. Raises on
    a missing, surplus or misshapen leaf."""
    used = set()
    state = {}
    for key, path, layout in flax_leaves(model):
        node = variables
        for k in path:
            if k not in node:
                raise ValueError(f"flax leaf {'/'.join(path)} is missing")
            node = node[k]
        used.add(path)
        value = np.asarray(node, np.float32)
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
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=False)
