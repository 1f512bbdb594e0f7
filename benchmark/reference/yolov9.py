"""Plain float32 YOLOv9e-seg forward, the benchmark's reference for the
configurations that name ``"reference": "yolov9"``.

Sources: Wang, Yeh and Liao, "YOLOv9: Learning What You Want to Learn Using
Programmable Gradient Information", arXiv:2402.13616; Ultralytics
``ultralytics/cfg/models/v9/yolov9e-seg.yaml``, with ``RepNCSPELAN4``,
``ADown``, ``SPPELAN``, ``CBLinear``, ``CBFuse``, ``RepCSP`` and
``RepBottleneck`` in ``ultralytics/nn/modules/block.py`` and ``RepConv`` in
``ultralytics/nn/modules/conv.py``. The yaml has no ``scales``: every width
and depth is as written there.

Written from those sources, not from the program. The graph, in the yaml's
layer numbering (``R`` a RepNCSPELAN4 of two RepCSP units):

* a first GELAN backbone, layers 1-9 (two stride-2 convolutions, then R,
  ADown, R, ADown, R, ADown, R);
* five CBLinear 1x1 convolutions with a bias, no BatchNorm, on layers 1, 3,
  5, 7 and 9, their outputs split into the pieces that each deeper level of
  the second backbone takes;
* a second backbone, layers 15-29, whose first five stages each end in a
  CBFuse: the stage's output plus piece k of every CBLinear on a level at or
  below it, each upsampled to the stage's size, nearest; then SPPELAN;
* the PAN neck of RepNCSPELAN4 and ADown, and the YOLOv8 Segment head (no
  block is a C3k2, so Ultralytics' ``parse_model`` keeps the legacy head),
  on widths 256, 512 and 512, with ``Proto(256, 256, 32)``.

Block equations (Ultralytics'): ``RepConv`` sums a 3x3 and a 1x1
convolution, each with its own BatchNorm, before the SiLU (kept as two
branches here; the program folds them); ``RepBottleneck`` is a RepConv, a
3x3 ConvBNAct and the shortcut; ``RepCSP`` a C3 of RepBottlenecks;
``RepNCSPELAN4`` ``cv4(cat(a, b, cv2(b), cv3(cv2(b))))``, ``a, b`` the halves
of ``cv1(x)``; ``ADown`` a 2x2 stride-1 average pool, its first half through
a 3x3 stride-2 convolution, its second through a 3x3 stride-2 max pool and a
1x1; ``SPPELAN`` three chained 5x5 max pools; ``CBFuse`` the sum, in list
order, of the interpolated pieces and the stage's output (Ultralytics'
``torch.stack(...).sum(0)``). Every convolution, BatchNorm and sum in
float32 (the caller turns TF32 off). The shared blocks (ConvBNAct, C3,
Bottleneck, Proto, the head's 1x1 convolutions) are ``reference/yolo.py``'s.

Departures from Ultralytics, each the program's own:

* stride-2 convolutions pad Flax "SAME" (the odd pixel on the bottom/right),
  not ``p=1`` (the two agree on ADown's odd-sized input);
* one class, the walkway;
* BatchNorm eps 1e-3;
* leaves named as Flax names them, in creation order
  (``RepNCSPELAN4_0/RepCSP_0/RepBottleneck_1/RepConv_0/ConvBNAct_1``,
  ``CBLinear_4/Conv_0``); Ultralytics' fixed 16-weight DFL convolution is
  not a leaf (the DFL decode is an arange).

``quant``: applied to every convolution's operands, the CBLinears' included
(``None`` is the reference; the precision control passes a rounding to
float8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import yolo
from benchmark.reference.yolo import C3, Bottleneck, Conv, ConvBNAct, Outputs, Proto, _q


class RepConv(nn.Module):
    """``silu(bn1(conv3x3(x)) + bn2(conv1x1(x)))``, both branches kept."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv1 = ConvBNAct(c_in, c_out, 3, act=False)
        self.conv2 = ConvBNAct(c_in, c_out, 1, act=False)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(Bottleneck):
    """A Bottleneck whose first convolution is a RepConv (expansion 1.0)."""

    def __init__(self, c_in, features, shortcut=True):
        super().__init__(c_in, features, shortcut, 1.0, (3, 3))
        self.cv1 = RepConv(c_in, features)


class RepCSP(C3):
    """A C3 (expansion 0.5) over n RepBottlenecks."""

    def __init__(self, c_in, features, n=1):
        super().__init__(c_in, features, n, True, 0.5)
        self.m = nn.ModuleList(RepBottleneck(self.cv1.conv.out_channels,
                                             self.cv1.conv.out_channels)
                               for _ in range(n))


class RepNCSPELAN4(nn.Module):
    """``cv4(cat(a, b, cv2(b), cv3(cv2(b))))``, ``a, b`` the halves of
    ``cv1(x)``; cv2 and cv3 a RepCSP of n units then a 3x3 ConvBNAct."""

    def __init__(self, c_in, c2, c3, c4, n=2):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c3, 1)
        self.cv2 = nn.ModuleList([RepCSP(c3 // 2, c4, n), ConvBNAct(c4, c4, 3)])
        self.cv3 = nn.ModuleList([RepCSP(c4, c4, n), ConvBNAct(c4, c4, 3)])
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for seq in (self.cv2, self.cv3):
            y = ys[-1]
            for layer in seq:
                y = layer(y)
            ys.append(y)
        return self.cv4(torch.cat(ys, dim=1))


class ADown(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.cv1 = ConvBNAct(c_in // 2, c_out // 2, 3, 2)
        self.cv2 = ConvBNAct(c_in // 2, c_out // 2, 1)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 1, 0, False, True)
        x1, x2 = x.chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class SPPELAN(nn.Module):
    def __init__(self, c_in, c_out, hidden, pool=5):
        super().__init__()
        self.pool = pool
        self.cv1 = ConvBNAct(c_in, hidden, 1)
        self.cv5 = ConvBNAct(4 * hidden, c_out, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.pool, 1, self.pool // 2))
        return self.cv5(torch.cat(ys, dim=1))


class CBLinear(nn.Module):
    """A 1x1 convolution with a bias, its output split into ``widths``."""

    def __init__(self, c_in, widths):
        super().__init__()
        self.widths = list(widths)
        self.conv = nn.Conv2d(c_in, sum(widths), 1, bias=True)
        self.quant = None

    def forward(self, x):
        c = self.conv
        return F.conv2d(_q(self.quant, x), _q(self.quant, c.weight), c.bias).split(
            self.widths, dim=1)


def cb_fuse(pieces, target):
    """Each piece upsampled to ``target``'s size, nearest, summed in list
    order with ``target`` last (Ultralytics' ``CBFuse``)."""
    ups = [F.interpolate(p, size=target.shape[2:], mode="nearest") for p in pieces]
    out = ups[0]
    for y in ups[1:] + [target]:
        out = out + y
    return out


# The yaml's levels: (RepNCSPELAN4 c2, c3, c4) of layers 3, 5, 7 and 9 (and
# of 19, 22, 25 and 28), each but the first after an ADown to its input's width.
LEVELS = [(256, 128, 64), (512, 256, 128), (1024, 512, 256), (1024, 512, 256)]
CB_WIDTHS = [64, 128, 256, 512, 1024]      # CBLinear 14's pieces; CBLinear i takes the first i + 1


def gelan(stems: bool = True) -> list[nn.Module]:
    """Layers 1-9 of a GELAN backbone (15-28 of the second without its fusions)."""
    layers = [ConvBNAct(3, 64, 3, 2), ConvBNAct(64, 128, 3, 2)]
    c = 128
    for i, (c2, c3, c4) in enumerate(LEVELS):
        if i:
            layers.append(ADown(c, c))
        layers.append(RepNCSPELAN4(c, c2, c3, c4, 2))
        c = c2
    return layers


class YoloSeg9(nn.Module):
    """images (B, 3, H, W) float32 in [0, 1] -> per-level head outputs."""

    def __init__(self, arch: str, num_classes: int = 1, reg_max: int = 16,
                 num_masks: int = 32):
        super().__init__()
        if arch != "yolov9e-seg":
            raise ValueError(f"the YOLOv9 reference has no {arch}")
        self.backbone = nn.ModuleList(gelan())
        self.cblinear = nn.ModuleList(CBLinear(c_in, CB_WIDTHS[:i + 1]) for i, c_in in
                                      enumerate((64, 256, 512, 1024, 1024)))
        self.backbone2 = nn.ModuleList(gelan() + [SPPELAN(1024, 512, 256)])
        self.h1 = RepNCSPELAN4(512 + 1024, 512, 512, 256, 2)      # 32
        self.n3 = RepNCSPELAN4(512 + 512, 256, 256, 128, 2)       # 35, P3
        self.d1 = ADown(256, 256)
        self.n4 = RepNCSPELAN4(256 + 512, 512, 512, 256, 2)       # 38, P4
        self.d2 = ADown(512, 512)
        self.n5 = RepNCSPELAN4(512 + 512, 512, 1024, 512, 2)      # 41, P5

        feats = [256, 512, 512]
        c_box = max(16, feats[0] // 4, reg_max * 4)
        c_cls = max(feats[0], min(num_classes, 100))
        c_m = max(feats[0] // 4, num_masks)
        heads = []
        for f in feats:
            box = [ConvBNAct(f, c_box, 3), ConvBNAct(c_box, c_box, 3),
                   Conv(c_box, 4 * reg_max, 1)]
            cls = [ConvBNAct(f, c_cls, 3), ConvBNAct(c_cls, c_cls, 3),
                   Conv(c_cls, num_classes, 1)]
            mask = [ConvBNAct(f, c_m, 3), ConvBNAct(c_m, c_m, 3), Conv(c_m, num_masks, 1)]
            heads.append(nn.ModuleList(
                [nn.ModuleList(box), nn.ModuleList(cls), nn.ModuleList(mask)]))
        self.heads = nn.ModuleList(heads)
        self.proto = Proto(256, 256, num_masks)

    def forward(self, images: torch.Tensor) -> Outputs:
        x, levels = images, []
        for i, layer in enumerate(self.backbone):
            x = layer(x)
            if i in (0, 2, 4, 6, 8):               # layers 1, 3, 5, 7, 9
                levels.append(x)
        pieces = [cb(z) for cb, z in zip(self.cblinear, levels)]
        x, k = images, 0
        for i, layer in enumerate(self.backbone2):
            x = layer(x)
            if i in (0, 1, 3, 5, 7):               # layers 15, 17, 20, 23, 26
                x = cb_fuse([p[k] for p in pieces[k:]], x)     # 16, 18, 21, 24, 27
                k += 1
            elif i == 4:
                p3 = x                             # 22
            elif i == 6:
                p4 = x                             # 25
        p5 = x                                     # 29

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


def build_model(config: dict) -> YoloSeg9:
    """The float32 model of a configuration."""
    return YoloSeg9(config["arch"], config["num_classes"], config["reg_max"],
                    config["num_mask_coeffs"])


set_quant = yolo.set_quant
flax_leaves = yolo.flax_leaves
load_flax_variables = yolo.load_flax_variables
