"""PyTorch YOLO-seg model family (YOLOv8-seg, YOLO11-seg, YOLO12-seg,
YOLOv9e-seg), NCHW; ``ARCHS`` maps each name to its family and scale.

Counterpart of ``vision_assist_tpu/models/yolo.py``: the same blocks, the
same channel and depth scaling, and the same arithmetic (bf16 convolutions
with float32 BatchNorm, eps 1e-3; float32 head convolutions). Every module
registers its children in the order the Flax module creates them in
``__call__``, so :func:`convert_flax_variables` can walk the tree and name
each leaf the way Flax does (``ConvBNAct_3``, ``C3k2_5``, ...).

One departure from the JAX package, to match Ultralytics' ``parse_model``:
every C3k2 takes ``c3k=True`` at scales m, l and x (the JAX package keeps it
False in backbone blocks 2 and 4 and the neck's first three blocks, so its
yolo11m-seg is not the published model; n and s are unchanged). One family
the JAX package does not have: YOLO12-seg (``yolo12{n,s,m,l,x}-seg``,
arXiv:2502.12524, ``ultralytics/cfg/models/12/yolo12-seg.yaml``), area
attention (:class:`AAttn`) in :class:`ABlock` units of :class:`A2C2f`, and
the YOLO11 head. Its Flax names follow the same rule; the A2C2f's residual
scale is the leaf ``A2C2f_k/gamma``. And YOLOv9e-seg (arXiv:2402.13616,
``ultralytics/cfg/models/v9/yolov9e-seg.yaml``), the one graph that is not a
backbone and a PAN neck: two GELAN backbones (:class:`RepNCSPELAN4`,
:class:`ADown`, :class:`SPPELAN`), five :class:`CBLinear` convolutions on
the first one's levels, and five CBFuse sums into the second's stages, each
one ``cb_fuse`` operator (``ops/cuda_cb_fuse.py``); each ADown's pools one
``adown_pool`` operator (``ops/cuda_adown.py``); its :class:`RepConv`
runs folded in eval mode; the YOLOv8 head on widths 256, 512 and 512.

Flax's ``padding="SAME"`` pads (0, 1) on a stride-2 3x3 convolution at an
even size, where ``nn.Conv2d(padding=1)`` would pad (1, 1). ``ConvBNAct`` works
out the SAME pads from its input's shape (:func:`_same_pads`): where they are
symmetric on both axes (every stride-1 convolution, and stride 2 on an odd
size) the convolution takes them as its own ``padding`` and no padded copy is
made; only the asymmetric ones (the 7 stride-2 convolutions a forward of the
served models), and every pad in train mode, are still made explicitly,
counted in ``pad_copies``.
In eval mode outside autograd, on channels_last activations (the served
layout), no block concatenates: each allocates its concatenation buffer and
every piece's producer stores into its channel slice (the epilogue through
``bn_act_into``, a residual sum through ``torch.add(..., out=)``, the neck's
2x upsample as one strided copy), with a contiguous copy from the same
epilogue where a convolution reads the piece too; only SPPF's pooled pieces
and a residual sum that a convolution also reads are still copied, counted
in ``cat_copies``. Train mode concatenates with ``torch.cat``.
Flax's ``ConvTranspose`` does not flip its kernel, PyTorch's does: the bridge
flips the spatial taps.

Serving stores every weight in the compute dtype. Training builds the model
with ``param_dtype=torch.float32`` (the Flax ``param_dtype``): the weights stay
float32 and each convolution casts its weight to the compute dtype, because an
SGD update of lr * g ~ 1e-5 is lost in a bf16 weight. In train mode
(``model.train()``) BatchNorm follows Flax, not ``nn.BatchNorm2d``: see
:func:`_flax_batch_norm_train`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from vision_assist_tpu_torch.ops.attention import sdpa_backend
from vision_assist_tpu_torch.ops.cuda_adown import adown_pool, adown_pool_plain
from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act, bn_act_into
from vision_assist_tpu_torch.ops.cuda_cb_fuse import cb_fuse, cb_fuse_plain
from vision_assist_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class YoloScale:
    depth: float
    width: float
    max_channels: int


SCALES = {
    "n": YoloScale(depth=1 / 3, width=1 / 4, max_channels=1024),
    "s": YoloScale(depth=1 / 3, width=1 / 2, max_channels=1024),
    "m": YoloScale(depth=2 / 3, width=3 / 4, max_channels=768),
}
SCALES_11 = {
    "n": YoloScale(depth=1 / 2, width=1 / 4, max_channels=1024),
    "s": YoloScale(depth=1 / 2, width=1 / 2, max_channels=1024),
    "m": YoloScale(depth=1 / 2, width=1.0, max_channels=512),
}
SCALES_12 = {
    "n": YoloScale(depth=0.50, width=0.25, max_channels=1024),
    "s": YoloScale(depth=0.50, width=0.50, max_channels=1024),
    "m": YoloScale(depth=0.50, width=1.00, max_channels=512),
    "l": YoloScale(depth=1.00, width=1.00, max_channels=512),
    "x": YoloScale(depth=1.00, width=1.50, max_channels=512),
}
# Scales whose every C3k2 takes c3k=True (Ultralytics' parse_model), and
# whose A2C2f takes a residual scale and an MLP ratio of 1.2 (2.0 elsewhere).
C3K_SCALES = "mlx"
RESIDUAL_SCALES = "lx"


@dataclasses.dataclass(frozen=True)
class Arch:
    """What an architecture's name stands for: its family, which picks the
    graph ("v8", "v11", "v12": one backbone and a PAN neck; "v9": two GELAN
    backbones joined by CBLinear/CBFuse), and its scale's letter."""
    family: str
    letter: str
    legacy: bool = False            # yolo11n-seg-legacy

    @property
    def scale(self) -> YoloScale | None:
        """The family's scale of this letter; None for YOLOv9e, whose yaml
        has no scales (every width and depth as written)."""
        return {"v8": SCALES, "v11": SCALES_11, "v12": SCALES_12}.get(self.family, {}).get(
            self.letter)


ARCHS = {
    **{f"yolov8{s}-seg": Arch("v8", s) for s in SCALES},
    **{f"yolo11{s}-seg": Arch("v11", s) for s in SCALES_11},
    "yolo11n-seg-legacy": Arch("v11", "n", legacy=True),
    **{f"yolo12{s}-seg": Arch("v12", s) for s in SCALES_12},
    "yolov9e-seg": Arch("v9", "e"),
}


def arch_of(name: str) -> Arch:
    """The table's entry for an architecture's name; raises on a name the
    port does not build."""
    if name not in ARCHS:
        raise ValueError(f"YoloSeg: no architecture {name!r}; one of {sorted(ARCHS)}")
    return ARCHS[name]


# YOLOv9e (``yolov9e-seg.yaml``): (c2, c3, c4) of each GELAN backbone's four
# RepNCSPELAN4, layers 3, 5, 7 and 9 (19, 22, 25 and 28), each but the first
# after an ADown to its input's width; and CBLinear 14's pieces, of which
# CBLinear i (on layer 1, 3, 5, 7, 9) makes the first i + 1.
GELAN_LEVELS = ((256, 128, 64), (512, 256, 128), (1024, 512, 256), (1024, 512, 256))
CB_WIDTHS = (64, 128, 256, 512, 1024)

# Flax's BatchNorm keeps 0.97 of the running statistics a step.
FLAX_BN_MOMENTUM = 0.97


def _round_ch(c: float) -> int:
    return max(int(round(c)), 1)


# Explicit pads ConvBNAct made since the last reset_pad_copies(): in eval mode
# one per convolution whose SAME pads are asymmetric, which its own padding
# cannot take; in train mode one per padded convolution. Each is a fill and a
# copy on the card.
pad_copies = 0


def reset_pad_copies() -> None:
    global pad_copies
    pad_copies = 0


# Concatenations and piece copies the blocks made since the last
# reset_cat_copies(): every torch.cat in train mode; where the pieces are
# stored in place, each cat still made (SPPF's) and each piece copied into its
# slice because no epilogue could store it there (a residual sum that a
# convolution reads as well).
cat_copies = 0


def reset_cat_copies() -> None:
    global cat_copies
    cat_copies = 0


def _cat(pieces: list[torch.Tensor]) -> torch.Tensor:
    global cat_copies
    cat_copies += 1
    return torch.cat(pieces, dim=1)


def _copy_into(out: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out.copy_(src)`` through aten's operator: the method's Python binding
    first sets a device guard, which a build without CUDA cannot, so a trace
    of the card's path on fake CUDA tensors would stop there (slices are
    ``narrow`` for the same reason: indexing sets one too)."""
    return torch.ops.aten.copy_.default(out, src)


def _copy_piece(out: torch.Tensor, piece: torch.Tensor) -> torch.Tensor:
    global cat_copies
    cat_copies += 1
    return _copy_into(out, piece)


def _in_place(block: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``block`` stores its pieces into its concatenation buffer: in
    eval mode, outside autograd (an ``out=`` store has no gradient), on a
    channels_last input (the layout ``bn_act_into`` stores into)."""
    return (not block.training and not torch.is_grad_enabled()
            and x.is_contiguous(memory_format=torch.channels_last))


def _empty(x: torch.Tensor, c: int) -> torch.Tensor:
    """A channels_last (B, c, H, W) tensor of ``x``'s batch, size, dtype and
    device."""
    b, _, h, w = x.shape
    return torch.empty((b, c, h, w), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def _store_sum(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor | None,
               also: torch.Tensor | None) -> torch.Tensor:
    """``x + y`` as a block's result: into ``out`` where given, and where a
    convolution reads it too, into ``also`` and copied to ``out``."""
    if out is None:
        if also is not None:
            raise ValueError("_store_sum: also is a store beside out")
        return x + y
    if also is None:
        return torch.add(x, y, out=out)
    torch.add(x, y, out=also)
    return _copy_piece(out, also)


def _upsample_into(out: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(z, scale_factor=2, mode="nearest")`` stored into
    ``out``: one strided copy of ``z`` expanded over a (B, C, H, 2, W, 2)
    view of it."""
    b, c, h, w = z.shape
    _copy_into(out.view(b, c, h, 2, w, 2), z.view(b, c, h, 1, w, 1).expand(b, c, h, 2, w, 2))
    return out


class _Concat:
    """A concatenation along channels of pieces of the given widths, the same
    wiring for both ways a block runs. In place (:func:`_in_place`), one
    channels_last buffer of ``like``'s batch and size (or ``buf``, a slice of
    the caller's), which each piece's producer stores into its slice of;
    otherwise the pieces, joined by ``torch.cat``."""

    def __init__(self, in_place: bool, like: torch.Tensor, widths: tuple[int, ...],
                 buf: torch.Tensor | None = None):
        self.widths = widths
        if buf is None and in_place:
            buf = _empty(like, sum(widths))
        self.buf = buf
        self.pieces: list[torch.Tensor | None] = [None] * len(widths)

    def slot(self, i: int, n: int = 1) -> torch.Tensor:
        """The buffer's slice that pieces ``i`` to ``i + n - 1`` take."""
        if n == len(self.widths):
            return self.buf
        return self.buf.narrow(1, sum(self.widths[:i]), sum(self.widths[i:i + n]))

    def put(self, i: int, m: nn.Module, x: torch.Tensor, keep: bool = False,
            n: int = 1) -> torch.Tensor:
        """Pieces ``i`` to ``i + n - 1`` as ``m(x)`` (a Sequential's last
        layer the one that stores). Returns what the next reader reads: with
        ``keep`` (a convolution reads the last piece too) that piece, in place
        a tensor of its own from the same store; else ``m(x)``."""
        if isinstance(m, nn.Sequential):        # A2C2f's two ABlocks
            *head, m = m
            for layer in head:
                x = layer(x)
        if self.buf is None:
            y = m(x)
            self.pieces[i:i + n] = y.split(self.widths[i:i + n], 1) if n > 1 else [y]
            return self.pieces[i + n - 1] if keep else y
        also = _empty(self.buf, self.widths[i + n - 1]) if keep else None
        y = m(x, out=self.slot(i, n), also=also)
        return y if also is None else also

    def upsample(self, i: int, z: torch.Tensor) -> None:
        """Piece ``i`` as ``z`` upsampled 2x, nearest."""
        if self.buf is None:
            self.pieces[i] = F.interpolate(z, scale_factor=2, mode="nearest")
        else:
            _upsample_into(self.slot(i), z)

    def join(self) -> torch.Tensor:
        return self.buf if self.buf is not None else _cat(self.pieces)


def _same_pads(x: torch.Tensor, k: int, s: int) -> list[int]:
    """XLA/TF "SAME" pads of ``x`` in ``F.pad``'s order (W before, W after,
    H before, H after): the odd pixel goes to the bottom/right."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA/TF "SAME" padding: the odd pixel goes to the bottom/right."""
    pads = _same_pads(x, k, s)
    return F.pad(x, pads) if any(pads) else x


def _flax_batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d,
                           global_sum=None) -> torch.Tensor:
    """Flax ``BatchNorm(use_running_average=False)`` on float32 ``y``:
    normalise by the batch mean and the biased batch variance over (N, H, W),
    and move the running statistics 0.03 of the way to them. The running
    variance takes the biased variance too; ``nn.BatchNorm2d`` would take the
    unbiased one and drift by n / (n - 1) a step.

    ``global_sum`` (data-parallel training, ``parallel/train_step.py``) is a
    differentiable sum over the ranks that split the batch: the statistics
    are then those of the global batch, from all-reduced per-channel sums
    (the mean, then the squared deviations from it)."""
    if global_sum is None:
        out = F.batch_norm(y, None, None, bn.weight, bn.bias, training=True,
                           eps=bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
    else:
        n = global_sum(y.new_tensor(float(y.numel() // y.shape[1])))
        mean = global_sum(y.sum(dim=(0, 2, 3))) / n
        dev = y - mean[None, :, None, None]
        var = global_sum((dev * dev).sum(dim=(0, 2, 3))) / n
        scale = torch.rsqrt(var + bn.eps) * bn.weight
        out = dev * scale[None, :, None, None] + bn.bias[None, :, None, None]
        mean, var = mean.detach(), var.detach()
    with torch.no_grad():
        bn.running_mean.lerp_(mean, 1.0 - FLAX_BN_MOMENTUM)
        bn.running_var.lerp_(var, 1.0 - FLAX_BN_MOMENTUM)
    return out


class ConvBNAct(nn.Module):
    """Conv (no bias, compute dtype) + BatchNorm (float32) + optional SiLU.
    The weight is cast to the compute dtype where it is stored in another.
    In eval mode BatchNorm, SiLU and the cast back are one call of the
    operator ``bn_act`` (``ops/cuda_bn_act.py``): one kernel launch on the
    card, its plain twin on the CPU; with ``out`` (eval mode only), of
    ``bn_act_into``, stored into that view and the last ``also.shape[1]``
    channels into ``also`` too."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.act, self.dtype = kernel, stride, act, dtype
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, groups=groups,
                              bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.03)
        # Set by data-parallel training to sum the batch statistics over
        # the ranks; None for one process.
        self.global_sum = None

    def pads_with_a_copy(self, x: torch.Tensor) -> bool:
        """Whether ``forward(x)`` pads ``x`` explicitly, reading it once
        into a padded copy."""
        return self._pad_copied(_same_pads(x, self.kernel, self.stride))

    def _pad_copied(self, pads: list[int]) -> bool:
        """Wherever there are pads in train mode (where the convolution pads
        itself, oneDNN's float32 backward sums the input's gradient in
        another order), where they are asymmetric in eval mode."""
        w0, w1, h0, h1 = pads
        return any(pads) and (self.training or w0 != w1 or h0 != h1)

    def forward(self, x: torch.Tensor, out: torch.Tensor | None = None,
                also: torch.Tensor | None = None) -> torch.Tensor:
        global pad_copies
        if (out is not None or also is not None) and (self.training or out is None):
            raise ValueError("ConvBNAct: out is a store of eval mode, also one beside out")
        conv, bn = self.conv, self.bn
        w0, _, h0, _ = pads = _same_pads(x, self.kernel, self.stride)
        padding = (h0, w0)
        if self._pad_copied(pads):
            x = F.pad(x, pads)
            pad_copies += 1
            padding = 0
        y = F.conv2d(x, conv.weight.to(self.dtype), None, conv.stride, padding,
                     1, conv.groups)
        if not self.training:
            stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                     self.act)
            if out is not None:
                # torch.export's trace on the card lays some convolution
                # outputs out as contiguous NCHW where the card answers
                # channels_last; eagerly this returns y itself.
                y = y.contiguous(memory_format=torch.channels_last)
                return bn_act_into(y, *stats, out, also)
            return bn_act(y, *stats)
        y = _flax_batch_norm_train(y.float(), bn, self.global_sum)
        return (F.silu(y) if self.act else y).to(self.dtype)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, kernels: tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, hidden, kernels[0], dtype=dtype)
        self.cv2 = ConvBNAct(hidden, features, kernels[1], dtype=dtype)
        self.add = shortcut and c_in == features

    def forward(self, x, out=None, also=None):
        """``out`` and ``also``: where the result is stored (a slice of the
        caller's concatenation buffer, a tensor for the next unit), eval mode
        only."""
        if not self.add:
            return self.cv2(self.cv1(x), out=out, also=also)
        return _store_sum(x, self.cv2(self.cv1(x)), out, also)


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (YOLOv8)."""

    def __init__(self, c_in: int, features: int, n: int = 1,
                 shortcut: bool = False, expansion: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1, dtype=dtype)
        self.m = nn.ModuleList(
            Bottleneck(hidden, hidden, shortcut, 1.0, (3, 3), dtype=dtype)
            for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1, dtype=dtype)
        self.hidden = hidden

    def forward(self, x, out=None, also=None):
        return _split_forward(self, x, out, also)


def _split_forward(block, x, out, also):
    """C2f and C3k2: ``cv2(cat([a, b, m1(b), m2(m1(b)), ...]))``, ``a`` and
    ``b`` the halves of ``cv1(x)``."""
    c, n = block.hidden, len(block.m)
    cat = _Concat(_in_place(block, x), x, (c,) * (2 + n))
    y = cat.put(0, block.cv1, x, keep=True, n=2)
    for i, m in enumerate(block.m):
        y = cat.put(2 + i, m, y, keep=i + 1 < n)
    return block.cv2(cat.join(), out=out, also=also)


class C3(nn.Module):
    def __init__(self, c_in: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 kernels: tuple[int, int] = (1, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, hidden, 1, dtype=dtype)
        self.m = nn.ModuleList(
            Bottleneck(hidden, hidden, shortcut, 1.0, kernels, dtype=dtype)
            for _ in range(n))
        self.cv2 = ConvBNAct(c_in, hidden, 1, dtype=dtype)
        self.cv3 = ConvBNAct(2 * hidden, features, 1, dtype=dtype)
        self.hidden = hidden

    def forward(self, x, out=None, also=None):
        c = self.hidden
        cat = _Concat(_in_place(self, x), x, (c, c))
        a = self.cv1(x)
        *head, last = self.m
        for m in head:
            a = m(a)
        cat.put(0, last, a)
        cat.put(1, self.cv2, x)
        return self.cv3(cat.join(), out=out, also=also)


class C3k2(nn.Module):
    """YOLO11 block: C2f whose inner units are C3k (when c3k) or Bottleneck."""

    def __init__(self, c_in: int, features: int, n: int = 1, c3k: bool = False,
                 shortcut: bool = True, expansion: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = _round_ch(features * expansion)
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1, dtype=dtype)
        self.m = nn.ModuleList(
            C3(hidden, hidden, 2, shortcut, kernels=(3, 3), dtype=dtype) if c3k
            else Bottleneck(hidden, hidden, shortcut, 0.5, (3, 3), dtype=dtype)
            for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1, dtype=dtype)
        self.hidden = hidden

    def forward(self, x, out=None, also=None):
        return _split_forward(self, x, out, also)


class SPPF(nn.Module):
    def __init__(self, c_in: int, features: int, pool: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = c_in // 2
        self.pool = pool
        self.cv1 = ConvBNAct(c_in, hidden, 1, dtype=dtype)
        self.cv2 = ConvBNAct(4 * hidden, features, 1, dtype=dtype)

    def forward(self, x, out=None, also=None):
        y = self.cv1(x)
        p = self.pool
        ys = [y]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], p, stride=1, padding=p // 2))
        return self.cv2(_cat(ys), out=out, also=also)


class Attention(nn.Module):
    """Multi-head attention over the spatial grid with a positional
    depthwise conv on v (YOLO11 PSA). Channels of qkv split per head as
    (nh, 2*key_dim + head_dim), exactly as the NHWC reference reshapes them."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5,
                 legacy: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.nh = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        qkv_dim = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = ConvBNAct(dim, qkv_dim, 1, act=legacy, dtype=dtype)
        self.pe = ConvBNAct(dim, dim, 3, groups=dim, act=legacy, dtype=dtype)
        self.proj = ConvBNAct(dim, dim, 1, act=legacy, dtype=dtype)

    def forward(self, x):
        b, _, h, w = x.shape
        nh, kd, hd = self.nh, self.key_dim, self.head_dim
        qkv = self.qkv(x).reshape(b, nh, 2 * kd + hd, h * w)
        q, k, v = torch.split(qkv, [kd, kd, hd], dim=2)
        attn = torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float())
        attn = torch.softmax(attn * (kd ** -0.5), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhdk->bhdq", attn.float(), v.float())
        out = out.to(x.dtype).reshape(b, nh * hd, h, w)
        pe = self.pe(v.reshape(b, nh * hd, h, w))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, legacy: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.attn = Attention(dim, num_heads, legacy=legacy, dtype=dtype)
        self.ffn1 = ConvBNAct(dim, dim * 2, 1, dtype=dtype)
        self.ffn2 = ConvBNAct(dim * 2, dim, 1, act=legacy, dtype=dtype)

    def forward(self, x, out=None, also=None):
        x = x + self.attn(x)
        return _store_sum(x, self.ffn2(self.ffn1(x)), out, also)


class C2PSA(nn.Module):
    def __init__(self, c_in: int, features: int, n: int = 1,
                 legacy: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = features // 2
        self.cv1 = ConvBNAct(c_in, 2 * hidden, 1, dtype=dtype)
        self.m = nn.ModuleList(
            PSABlock(hidden, max(1, hidden // 64), legacy=legacy, dtype=dtype)
            for _ in range(n))
        self.cv2 = ConvBNAct(2 * hidden, features, 1, dtype=dtype)
        self.hidden = hidden

    def forward(self, x, out=None, also=None):
        c = self.hidden
        cat = _Concat(_in_place(self, x), x, (c, c))
        b = cat.put(0, self.cv1, x, keep=True, n=2)
        *head, last = self.m
        for m in head:
            b = m(b)
        cat.put(1, last, b)          # over cv1's second half
        return self.cv2(cat.join(), out=out, also=also)


class AAttn(nn.Module):
    """YOLO12 area attention: heads of ``dim // num_heads`` channels over the
    tokens of the grid in row-major order, cut into ``area`` consecutive runs
    (row strips where the rows divide evenly) that attend within
    themselves; ``area`` 1 is full attention. qkv channels split per head as
    [q | k | v], each ``head_dim`` wide. Then ``proj(out + pe(v))``, pe a 7x7
    depthwise convolution. One fused attention call a forward: the areas
    fold into the batch and q, k, v are views of the qkv output."""

    def __init__(self, dim: int, num_heads: int, area: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.area, self.nh = area, num_heads
        self.head_dim = dim // num_heads
        self.qkv = ConvBNAct(dim, 3 * dim, 1, act=False, dtype=dtype)
        self.proj = ConvBNAct(dim, dim, 1, act=False, dtype=dtype)
        self.pe = ConvBNAct(dim, dim, 7, groups=dim, act=False, dtype=dtype)

    def forward(self, x):
        with spans.span("program.segment.aattn"):
            b, c, h, w = x.shape
            n, nh, hd = h * w, self.nh, self.head_dim
            tokens = self.qkv(x).flatten(2).transpose(1, 2)          # (B, N, 3C)
            qkv = tokens.reshape(b * self.area, n // self.area, nh, 3, hd)
            q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
            with sdpa_kernel(sdpa_backend(q)):
                out = F.scaled_dot_product_attention(q, k, v)       # (B', nh, T, hd)

            def grid(t):       # (B', nh, T, hd) -> (B, C, H, W)
                return t.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)

            return self.proj(grid(out) + self.pe(grid(v)))


class ABlock(nn.Module):
    """Area attention, then a 1x1 MLP (SiLU inside, none at its output),
    each with a residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2,
                 area: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area, dtype=dtype)
        self.mlp = nn.Sequential(ConvBNAct(dim, hidden, 1, dtype=dtype),
                                 ConvBNAct(hidden, dim, 1, act=False, dtype=dtype))

    def forward(self, x, out=None, also=None):
        x = x + self.attn(x)
        return _store_sum(x, self.mlp(x), out, also)


class A2C2f(nn.Module):
    """YOLO12's R-ELAN block: ``y = [cv1(x)]``, each of n units applied to
    the last entry (two ABlocks with ``a2``, else a C3k of 2 bottlenecks),
    ``cv2(cat(y))``; with ``residual`` (an ``a2`` block at scales l and x)
    the output is ``x + gamma * cv2(...)``, ``gamma`` a learned scale a
    channel."""

    def __init__(self, c_in: int, features: int, n: int = 1, a2: bool = True,
                 area: int = 1, residual: bool = False, mlp_ratio: float = 2.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = features // 2
        if hidden % 32:
            raise ValueError(f"A2C2f: {hidden} hidden channels; ABlock takes "
                             "a multiple of 32")
        self.cv1 = ConvBNAct(c_in, hidden, 1, dtype=dtype)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(hidden, hidden // 32, mlp_ratio, area, dtype=dtype)
                            for _ in range(2))) if a2
            else C3(hidden, hidden, 2, True, kernels=(3, 3), dtype=dtype)
            for _ in range(n))
        self.cv2 = ConvBNAct((1 + n) * hidden, features, 1, dtype=dtype)
        self.gamma = (nn.Parameter(torch.full((features,), 0.01, dtype=dtype))
                      if a2 and residual else None)
        self.hidden = hidden

    def forward(self, x, out=None, also=None):
        c, n = self.hidden, len(self.m)
        cat = _Concat(_in_place(self, x), x, (c,) * (1 + n))
        y = cat.put(0, self.cv1, x, keep=True)
        for i, m in enumerate(self.m):
            y = cat.put(1 + i, m, y, keep=i + 1 < n)
        if self.gamma is None:
            return self.cv2(cat.join(), out=out, also=also)
        y = self.cv2(cat.join())
        return _store_sum(x, self.gamma.to(y.dtype).view(1, -1, 1, 1) * y, out, also)


class RepConv(nn.Module):
    """YOLOv9's re-parameterisable 3x3 convolution: a 3x3 and a 1x1
    ConvBNAct (no SiLU), summed, then SiLU, in train mode.

    In eval mode it is the deployed form (Ultralytics' ``RepConv.fuse_convs``):
    one 3x3 convolution whose weight and bias fold both branches and both
    BatchNorms, in float32, then the epilogue with SiLU (``bn_act`` with the
    identity's statistics and the folded bias). The fold is made when the
    module enters eval mode and when a state dict is loaded into it there;
    the branches' weights are kept in float32 for it, and the folded weight
    is cast once to the compute dtype."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBNAct(c_in, c_out, 3, act=False, dtype=dtype)
        self.conv2 = ConvBNAct(c_in, c_out, 1, act=False, dtype=dtype)
        for branch in (self.conv1, self.conv2):
            branch.conv.to(torch.float32)
        self.register_buffer("fused_weight", torch.zeros(c_out, c_in, 3, 3, dtype=dtype),
                             persistent=False)
        self.register_buffer("fused_bias", torch.zeros(c_out), persistent=False)
        self.register_buffer("_ones", torch.ones(c_out), persistent=False)
        self.register_buffer("_zeros", torch.zeros(c_out), persistent=False)
        self.register_load_state_dict_post_hook(lambda m, _: m._fold() if not m.training
                                                else None)

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:
            self._fold()
        return self

    @staticmethod
    def _folded(branch: ConvBNAct) -> tuple[torch.Tensor, torch.Tensor]:
        bn = branch.bn
        std = (bn.running_var + bn.eps).sqrt()
        t = (bn.weight / std).reshape(-1, 1, 1, 1)
        return branch.conv.weight.float() * t, bn.bias - bn.running_mean * bn.weight / std

    @torch.no_grad()
    def _fold(self) -> None:
        k3, b3 = self._folded(self.conv1)
        k1, b1 = self._folded(self.conv2)
        self.fused_weight.copy_(k3 + F.pad(k1, [1, 1, 1, 1]))
        self.fused_bias.copy_(b3 + b1)

    def forward(self, x):
        if self.training:
            return F.silu(self.conv1(x) + self.conv2(x))
        y = F.conv2d(x, self.fused_weight, None, 1, 1)
        return bn_act(y, self._ones, self.fused_bias, self._zeros, self._ones, 0.0, True)


class RepBottleneck(Bottleneck):
    """A Bottleneck (expansion 1.0, 3x3 then 3x3, a shortcut) whose first
    convolution is a RepConv."""

    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(c_in, features, shortcut, 1.0, (3, 3), dtype=dtype)
        self.cv1 = RepConv(c_in, features, dtype=dtype)


class RepCSP(C3):
    """A C3 (expansion 0.5) over n RepBottlenecks."""

    def __init__(self, c_in: int, features: int, n: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(c_in, features, n, True, 0.5, dtype=dtype)
        self.m = nn.ModuleList(RepBottleneck(self.hidden, self.hidden, dtype=dtype)
                               for _ in range(n))


class RepNCSPELAN4(nn.Module):
    """YOLOv9's GELAN block: ``cv4(cat(a, b, cv2(b), cv3(cv2(b))))``, ``a``
    and ``b`` the halves of ``cv1(x)``, cv2 and cv3 each a RepCSP of n units
    then a 3x3 ConvBNAct."""

    def __init__(self, c_in: int, c2: int, c3: int, c4: int, n: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c3, 1, dtype=dtype)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n, dtype=dtype),
                                 ConvBNAct(c4, c4, 3, dtype=dtype))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n, dtype=dtype),
                                 ConvBNAct(c4, c4, 3, dtype=dtype))
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1, dtype=dtype)
        self.widths = (c3 // 2, c3 // 2, c4, c4)

    def forward(self, x, out=None, also=None):
        cat = _Concat(_in_place(self, x), x, self.widths)
        y = cat.put(0, self.cv1, x, keep=True, n=2)
        y = cat.put(2, self.cv2, y, keep=True)
        cat.put(3, self.cv3, y)
        return self.cv4(cat.join(), out=out, also=also)


class ADown(nn.Module):
    """YOLOv9's downsampling: a 2x2 stride-1 average pool, then the first
    half of the channels through a 3x3 stride-2 ConvBNAct and the second
    through a 3x3 stride-2 max pool and a 1x1 ConvBNAct, concatenated. The
    pools and the split are one ``adown_pool`` operator in eval mode
    (``ops/cuda_adown.py``: one kernel launch on the card) and its plain
    twin in train mode."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = c_out // 2
        self.cv1 = ConvBNAct(c_in // 2, self.hidden, 3, 2, dtype=dtype)
        self.cv2 = ConvBNAct(c_in // 2, self.hidden, 1, dtype=dtype)

    def forward(self, x, out=None, also=None):
        if also is not None:
            raise ValueError("ADown: also is a store of a single piece")
        in_place = _in_place(self, x)
        x1, x2 = adown_pool_plain(x) if self.training else adown_pool(x)
        cat = _Concat(in_place, x2, (self.hidden, self.hidden), buf=out)
        cat.put(0, self.cv1, x1)
        cat.put(1, self.cv2, x2)
        return cat.join()


class SPPELAN(nn.Module):
    """A 1x1 ConvBNAct, three chained 5x5 max pools, a 1x1 over the four."""

    def __init__(self, c_in: int, c_out: int, hidden: int, pool: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pool = pool
        self.cv1 = ConvBNAct(c_in, hidden, 1, dtype=dtype)
        self.cv5 = ConvBNAct(4 * hidden, c_out, 1, dtype=dtype)

    def forward(self, x, out=None, also=None):
        ys = [self.cv1(x)]
        p = self.pool
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], p, stride=1, padding=p // 2))
        return self.cv5(_cat(ys), out=out, also=also)


class CBLinear(nn.Module):
    """A 1x1 convolution with a bias (no BatchNorm), its output split into
    the pieces of ``widths`` (views, no copy)."""

    def __init__(self, c_in: int, widths: tuple[int, ...],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.widths = dtype, tuple(widths)
        self.conv = nn.Conv2d(c_in, sum(widths), 1, bias=True, dtype=dtype)

    def forward(self, x):
        c = self.conv
        return F.conv2d(x, c.weight.to(self.dtype), c.bias.to(self.dtype)).split(
            self.widths, 1)


class Proto(nn.Module):
    """Mask prototype head (from P3): conv, 2x transposed conv, conv, 1x1."""

    def __init__(self, c_in: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, hidden, 3, dtype=dtype)
        self.up = nn.ConvTranspose2d(hidden, hidden, 2, 2, bias=True, dtype=dtype)
        self.cv2 = ConvBNAct(hidden, hidden, 3, dtype=dtype)
        self.cv3 = ConvBNAct(hidden, out, 1, dtype=dtype)

    def forward(self, x):
        x = self.cv1(x)
        up = self.up
        x = F.conv_transpose2d(x, up.weight.to(x.dtype), up.bias.to(x.dtype),
                               up.stride)
        return self.cv3(self.cv2(x))


@dataclasses.dataclass
class YoloSegOutputs:
    """Raw per-level head outputs plus prototypes (all NCHW, float32)."""

    box_logits: list[torch.Tensor]   # per level (B, 4*reg_max, H, W)
    cls_logits: list[torch.Tensor]   # per level (B, nc, H, W)
    coeffs: list[torch.Tensor]       # per level (B, nm, H, W)
    protos: torch.Tensor             # (B, nm, Hp, Wp)
    strides: tuple[int, ...]


class YoloSeg(nn.Module):
    """YOLOv8/9/11/12 segmentation model, the family and scale chosen by the
    table ``ARCHS``; images (B, 3, H, W) float in [0, 1].

    ``dtype`` is the compute dtype of the convolutions; ``param_dtype`` (the
    compute dtype when None) the dtype their weights are stored in. The head's
    1x1 convolutions and BatchNorm are float32 either way."""

    def __init__(self, arch: str = "yolov8n-seg", num_classes: int = 1,
                 reg_max: int = 16, num_masks: int = 32,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.arch, self.reg_max, self.dtype = arch, reg_max, dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        spec = arch_of(arch)
        self.family = spec.family
        if spec.family == "v9":
            feats = self._build_gelan(dtype)
        else:
            feats = self._build_pan(spec, dtype)
        dt = dtype
        c_box = max(16, feats[0] // 4, reg_max * 4)
        c_cls = max(feats[0], min(num_classes, 100))
        c_m = max(feats[0] // 4, num_masks)
        heads = []
        for f in feats:
            box = [ConvBNAct(f, c_box, 3, dtype=dt),
                   ConvBNAct(c_box, c_box, 3, dtype=dt),
                   nn.Conv2d(c_box, 4 * reg_max, 1)]
            if self.family in ("v11", "v12"):
                cls = [ConvBNAct(f, f, 3, groups=f, dtype=dt),
                       ConvBNAct(f, c_cls, 1, dtype=dt),
                       ConvBNAct(c_cls, c_cls, 3, groups=c_cls, dtype=dt),
                       ConvBNAct(c_cls, c_cls, 1, dtype=dt)]
            else:
                cls = [ConvBNAct(f, c_cls, 3, dtype=dt),
                       ConvBNAct(c_cls, c_cls, 3, dtype=dt)]
            cls.append(nn.Conv2d(c_cls, num_classes, 1))
            mask = [ConvBNAct(f, c_m, 3, dtype=dt),
                    ConvBNAct(c_m, c_m, 3, dtype=dt),
                    nn.Conv2d(c_m, num_masks, 1)]
            heads.append(nn.ModuleList(
                [nn.ModuleList(box), nn.ModuleList(cls), nn.ModuleList(mask)]))
        self.heads = nn.ModuleList(heads)
        self.proto = Proto(feats[0], feats[0], num_masks, dtype=dt)
        if self.param_dtype != dtype:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) \
                        and m.weight.dtype == dtype:
                    m.to(self.param_dtype)
                elif isinstance(m, A2C2f) and m.gamma is not None:
                    m.gamma.data = m.gamma.data.to(self.param_dtype)

    def _build_pan(self, spec: Arch, dt: torch.dtype) -> list[int]:
        """One backbone and the PAN neck (YOLOv8, YOLO11, YOLO12); returns
        the head's widths."""
        is_v11, is_v12, legacy = spec.family == "v11", spec.family == "v12", spec.legacy
        letter, s = spec.letter, spec.scale
        c3k = letter in C3K_SCALES

        def ch(c: int) -> int:
            return _round_ch(min(c, s.max_channels) * s.width)

        def depth(n: int) -> int:
            return max(int(round(n * s.depth)), 1)

        if is_v11:
            self.backbone = nn.ModuleList([
                ConvBNAct(3, ch(64), 3, 2, dtype=dt),
                ConvBNAct(ch(64), ch(128), 3, 2, dtype=dt),
                C3k2(ch(128), ch(256), depth(2), c3k=c3k, shortcut=True,
                     expansion=0.25, dtype=dt),
                ConvBNAct(ch(256), ch(256), 3, 2, dtype=dt),
                C3k2(ch(256), ch(512), depth(2), c3k=c3k, shortcut=True,
                     expansion=0.25, dtype=dt),                        # P3
                ConvBNAct(ch(512), ch(512), 3, 2, dtype=dt),
                C3k2(ch(512), ch(512), depth(2), c3k=True, shortcut=True,
                     dtype=dt),                                        # P4
                ConvBNAct(ch(512), ch(1024), 3, 2, dtype=dt),
                C3k2(ch(1024), ch(1024), depth(2), c3k=True, shortcut=True,
                     dtype=dt),
                SPPF(ch(1024), ch(1024), 5, dtype=dt),
                C2PSA(ch(1024), ch(1024), depth(2), legacy=legacy, dtype=dt),
            ])
            c_p3, c_p4 = ch(512), ch(512)
            if legacy:
                def block(ci, c, n, sc, last=False):
                    return C3k2(ci, c, depth(n), c3k=False, shortcut=sc, dtype=dt)
            else:
                def block(ci, c, n, sc, last=False):
                    return C3k2(ci, c, depth(n), c3k=c3k or last, shortcut=True,
                                dtype=dt)
            neck_n = 2
        elif is_v12:
            residual = letter in RESIDUAL_SCALES
            mlp_ratio = 1.2 if residual else 2.0
            self.backbone = nn.ModuleList([
                ConvBNAct(3, ch(64), 3, 2, dtype=dt),
                ConvBNAct(ch(64), ch(128), 3, 2, groups=2, dtype=dt),
                C3k2(ch(128), ch(256), depth(2), c3k=c3k, shortcut=True,
                     expansion=0.25, dtype=dt),
                ConvBNAct(ch(256), ch(256), 3, 2, groups=4, dtype=dt),
                C3k2(ch(256), ch(512), depth(2), c3k=c3k, shortcut=True,
                     expansion=0.25, dtype=dt),                        # P3
                ConvBNAct(ch(512), ch(512), 3, 2, dtype=dt),
                A2C2f(ch(512), ch(512), depth(4), True, 4, residual, mlp_ratio,
                      dtype=dt),                                       # P4
                ConvBNAct(ch(512), ch(1024), 3, 2, dtype=dt),
                A2C2f(ch(1024), ch(1024), depth(4), True, 1, residual, mlp_ratio,
                      dtype=dt),
            ])
            c_p3, c_p4 = ch(512), ch(512)

            def block(ci, c, n, sc, last=False):
                if last:
                    return C3k2(ci, c, depth(n), c3k=True, shortcut=True, dtype=dt)
                return A2C2f(ci, c, depth(n), a2=False, dtype=dt)
            neck_n = 2
        else:
            self.backbone = nn.ModuleList([
                ConvBNAct(3, ch(64), 3, 2, dtype=dt),
                ConvBNAct(ch(64), ch(128), 3, 2, dtype=dt),
                C2f(ch(128), ch(128), depth(3), shortcut=True, dtype=dt),
                ConvBNAct(ch(128), ch(256), 3, 2, dtype=dt),
                C2f(ch(256), ch(256), depth(6), shortcut=True, dtype=dt),  # P3
                ConvBNAct(ch(256), ch(512), 3, 2, dtype=dt),
                C2f(ch(512), ch(512), depth(6), shortcut=True, dtype=dt),  # P4
                ConvBNAct(ch(512), ch(1024), 3, 2, dtype=dt),
                C2f(ch(1024), ch(1024), depth(3), shortcut=True, dtype=dt),
                SPPF(ch(1024), ch(1024), 5, dtype=dt),
            ])
            c_p3, c_p4 = ch(256), ch(512)

            def block(ci, c, n, sc, last=False):
                return C2f(ci, c, depth(n), shortcut=sc, dtype=dt)
            neck_n = 3
        c_p5 = ch(1024)
        self._p3_at, self._p4_at = 4, 6
        self._widths = (c_p3, c_p4, c_p5, ch(256), ch(512))

        # PAN neck, registered in the reference's creation order.
        self.h1 = block(c_p5 + c_p4, ch(512), neck_n, False)
        self.n3 = block(ch(512) + c_p3, ch(256), neck_n, False)
        self.d1 = ConvBNAct(ch(256), ch(256), 3, 2, dtype=dt)
        self.n4 = block(ch(256) + ch(512), ch(512), neck_n, False)
        self.d2 = ConvBNAct(ch(512), ch(512), 3, 2, dtype=dt)
        self.n5 = block(ch(512) + c_p5, ch(1024), neck_n, False, last=True)
        return [ch(256), ch(512), ch(1024)]

    def _build_gelan(self, dt: torch.dtype) -> list[int]:
        """YOLOv9e's two GELAN backbones, the five CBLinears between them and
        its neck, registered in the reference's creation order (the yaml's
        layers 1-9, 10-14, 15-29, then 30-41); returns the head's widths."""
        def gelan() -> list[nn.Module]:
            layers = [ConvBNAct(3, 64, 3, 2, dtype=dt), ConvBNAct(64, 128, 3, 2, dtype=dt)]
            c = 128
            for i, (c2, c3, c4) in enumerate(GELAN_LEVELS):
                if i:
                    layers.append(ADown(c, c, dtype=dt))
                layers.append(RepNCSPELAN4(c, c2, c3, c4, 2, dtype=dt))
                c = c2
            return layers

        self.backbone = nn.ModuleList(gelan())
        self.cblinear = nn.ModuleList(
            CBLinear(c_in, CB_WIDTHS[:i + 1], dtype=dt)
            for i, c_in in enumerate((64, 256, 512, 1024, 1024)))
        self.backbone2 = nn.ModuleList(gelan() + [SPPELAN(1024, 512, 256, dtype=dt)])
        self.h1 = RepNCSPELAN4(512 + 1024, 512, 512, 256, 2, dtype=dt)      # 32
        self.n3 = RepNCSPELAN4(512 + 512, 256, 256, 128, 2, dtype=dt)       # 35, P3
        self.d1 = ADown(256, 256, dtype=dt)
        self.n4 = RepNCSPELAN4(256 + 512, 512, 512, 256, 2, dtype=dt)       # 38, P4
        self.d2 = ADown(512, 512, dtype=dt)
        self.n5 = RepNCSPELAN4(512 + 512, 512, 1024, 512, 2, dtype=dt)      # 41, P5
        return [256, 512, 512]

    @property
    def is_v11(self) -> bool:
        return self.family == "v11"

    @property
    def is_v12(self) -> bool:
        return self.family == "v12"

    @property
    def is_v11_legacy(self) -> bool:
        """arch "yolo11n-seg-legacy": the v11 variant the first y11n
        checkpoint was trained with (no shortcut in the neck's C3k2, no c3k in
        the P5 neck block, SiLU on the attention's qkv, pe and proj and on the
        FFN's output)."""
        return arch_of(self.arch).legacy

    def forward(self, images: torch.Tensor) -> YoloSegOutputs:
        x = images.to(self.dtype)
        n3, n4, n5 = self._gelan(x) if self.family == "v9" else self._pan(x)
        branches: list[list[torch.Tensor]] = [[], [], []]
        for f, head in zip([n3, n4, n5], self.heads):
            for out, branch in zip(branches, head):
                y = f
                for layer in branch[:-1]:
                    y = layer(y)
                out.append(branch[-1](y.float()))
        return YoloSegOutputs(
            box_logits=branches[0], cls_logits=branches[1], coeffs=branches[2],
            protos=self.proto(n3).float(), strides=(8, 16, 32))

    def _pan(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The backbone and the PAN neck: (n3, n4, n5)."""
        in_place = _in_place(self, x)
        c3, c4, c5, c_n3, c_h1 = self._widths
        # The PAN neck's four concatenations, [up(p5), p4] into h1, [up(h1),
        # p3] into n3, [d1(n3), h1] into n4 and [d2(n4), p5] into n5, each
        # made at the backbone level of its size, from that level's input,
        # before any piece: each level's block keeps its input's size.
        for i, layer in enumerate(self.backbone):
            if i == self._p3_at:
                to_n3 = _Concat(in_place, x, (c_h1, c3))
                x = self._level(to_n3, i, x)
            elif i == self._p4_at:
                to_h1 = _Concat(in_place, x, (c5, c4))
                to_n4 = _Concat(in_place, x, (c_n3, c_h1))
                x = self._level(to_h1, i, x)
            elif i == len(self.backbone) - 1:
                to_n5 = _Concat(in_place, x, (c_h1, c5))
                p5 = to_n5.put(1, layer, x)
            else:
                x = layer(x)
        to_h1.upsample(0, p5)
        h1 = to_n4.put(1, self.h1, to_h1.join())
        to_n3.upsample(0, h1)
        n3 = self.n3(to_n3.join())
        to_n4.put(0, self.d1, n3)
        n4 = self.n4(to_n4.join())
        to_n5.put(0, self.d2, n4)
        n5 = self.n5(to_n5.join())
        return n3, n4, n5

    def _gelan(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """YOLOv9's two backbones and its neck: (n3, n4, n5). The first
        backbone and the CBLinears run in the span ``program.segment.aux``;
        each of the second backbone's five fusions (layers 16, 18, 21, 24
        and 27) is one ``cb_fuse`` in a ``program.segment.cbfuse`` span. The
        neck's four concatenations are made as the PAN neck's are, each at
        the first tensor of its size: [up(p5), p4] into h1, [up(h1), p3]
        into n3, [d1(n3), h1] into n4, [d2(n4), p5] into n5; P3 and P4 are
        stored into them and, for the ADown that reads each, into a tensor
        of their own from the same store."""
        in_place = _in_place(self, x)
        with spans.span("program.segment.aux"):
            levels, y = [], x
            for i, layer in enumerate(self.backbone):
                y = layer(y)
                if i % 2 == 0:                         # layers 1, 3, 5, 7, 9
                    levels.append(y)
            pieces = [cb(z) for cb, z in zip(self.cblinear, levels)]

        def fuse(k: int, target: torch.Tensor) -> torch.Tensor:
            with spans.span("program.segment.cbfuse"):
                chosen = [p[k] for p in pieces[k:]]
                return cb_fuse_plain(chosen, target) if self.training \
                    else cb_fuse(chosen, target)

        b = self.backbone2
        c_p3, c_p4 = GELAN_LEVELS[1][0], GELAN_LEVELS[2][0]
        c_p5 = b[-1].cv5.conv.out_channels
        c_h1, c_n3 = self.h1.cv4.conv.out_channels, self.n3.cv4.conv.out_channels
        y = fuse(1, b[1](fuse(0, b[0](x))))            # 15-18
        y = fuse(2, b[3](b[2](y)))                     # 19-21
        to_n3 = _Concat(in_place, y, (c_h1, c_p3))
        y = fuse(3, b[5](to_n3.put(1, b[4], y, keep=True)))      # 22 (P3), 23, 24
        to_h1 = _Concat(in_place, y, (c_p5, c_p4))
        to_n4 = _Concat(in_place, y, (c_n3, c_h1))
        y = fuse(4, b[7](to_h1.put(1, b[6], y, keep=True)))      # 25 (P4), 26, 27
        to_n5 = _Concat(in_place, y, (c_h1, c_p5))
        p5 = to_n5.put(1, b[9], b[8](y))               # 28, 29 (P5)
        to_h1.upsample(0, p5)
        h1 = to_n4.put(1, self.h1, to_h1.join())       # 30-32
        to_n3.upsample(0, h1)
        n3 = self.n3(to_n3.join())                     # 33-35
        to_n4.put(0, self.d1, n3)
        n4 = self.n4(to_n4.join())                     # 36-38
        to_n5.put(0, self.d2, n4)
        n5 = self.n5(to_n5.join())                     # 39-41
        return n3, n4, n5

    def _level(self, cat: _Concat, i: int, x: torch.Tensor) -> torch.Tensor:
        """Backbone level ``i`` (P3 or P4) as the last piece of ``cat``, the
        neck's concatenation that takes it. Returns what the next backbone
        convolution reads: in place, the slice itself where that convolution
        pads the level's output with a copy (the copy reads it once), else a
        tensor of its own from the same store."""
        keep = cat.buf is not None and not self.backbone[i + 1].pads_with_a_copy(cat.slot(1))
        return cat.put(1, self.backbone[i], x, keep=keep)


# --- Flax weight bridge ------------------------------------------------------------

_FLAX_NAMES = {nn.Conv2d: "Conv", nn.BatchNorm2d: "BatchNorm",
               nn.ConvTranspose2d: "ConvTranspose"}


def _flax_children(module: nn.Module):
    """(flax name, child) in creation order; containers are transparent."""
    counts: dict[str, int] = {}
    out = []

    def visit(m):
        for child in m.children():
            if isinstance(child, (nn.ModuleList, nn.Sequential)):
                visit(child)
                continue
            kind = _FLAX_NAMES.get(type(child), type(child).__name__)
            n = counts.get(kind, 0)
            counts[kind] = n + 1
            out.append((f"{kind}_{n}", child))

    visit(module)
    return out


def flax_leaves(model: YoloSeg) -> list[tuple[str, tuple[str, ...], str]]:
    """(``state_dict`` key, Flax path, layout) of every tensor that has a Flax
    leaf, in the Flax module's creation order. Layout "conv" is a kernel stored
    HWIO in Flax and OIHW here (depthwise (3,3,1,C) <-> (C,1,3,3));
    "conv_transpose" a kernel (kh,kw,in,out) in Flax and (in,out,kh,kw) with
    both spatial axes flipped here; "same" the same array on both sides. A
    parameter a block holds itself (A2C2f's ``gamma``) is a "same" leaf of
    the block's own name, after its children's."""
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
                for pname, _ in child.named_parameters(recurse=False):
                    out.append((f"{name}.{pname}", p + (pname,), "same"))

    walk(model, ())
    return out


def _from_flax(value: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return value.transpose(3, 2, 0, 1)
    if layout == "conv_transpose":
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return value


def _to_flax(value: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        value = value.transpose(2, 3, 1, 0)
    elif layout == "conv_transpose":
        value = value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return np.ascontiguousarray(value)


def convert_flax_variables(variables, model: YoloSeg) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree -> ``model.state_dict()`` keys.

    Conv kernels go HWIO -> OIHW (depthwise (3,3,1,C) -> (C,1,3,3));
    ConvTranspose kernels go (kh,kw,in,out) -> (in,out,kh,kw) with both
    spatial axes flipped. Raises if a Flax leaf is left unconsumed or a
    model tensor is left unfilled, or if any shape disagrees."""
    consumed: set[tuple[str, ...]] = set()
    want = model.state_dict()
    state: dict[str, torch.Tensor] = {}

    def take(path: tuple[str, ...]) -> np.ndarray:
        node = variables
        try:
            for k in path:
                node = node[k]
        except KeyError:
            raise ValueError(f"flax leaf {'/'.join(path)} is missing") from None
        consumed.add(path)
        return np.asarray(node)

    for key, path, layout in flax_leaves(model):
        value = _from_flax(take(path), layout)
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: flax shape {value.shape} != "
                             f"{tuple(want[key].shape)}")
        state[key] = torch.from_numpy(np.array(value))
    for key in want:
        if key.endswith(".num_batches_tracked"):
            state[key] = torch.tensor(0)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path

    left = [p for p in leaves(variables) if p not in consumed]
    if left:
        raise ValueError(f"{len(left)} flax leaves not consumed, e.g. {left[:3]}")
    missing = set(want) - set(state)
    if missing:
        raise ValueError(f"model tensors not filled: {sorted(missing)[:5]}")
    return state


def to_flax_variables(model: YoloSeg,
                      state: dict[str, torch.Tensor] | None = None) -> dict:
    """The inverse of :func:`convert_flax_variables`: ``state`` (the model's
    own ``state_dict()`` when None) as the Flax ``{"params", "batch_stats"}``
    tree of float32 numpy arrays, the tree Flax's ``param_dtype=float32``
    model holds."""
    state = model.state_dict() if state is None else state
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, path, layout in flax_leaves(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        value = state[key].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = _to_flax(value, layout)
    return tree


def weight_decay_mask(model: YoloSeg) -> list[bool]:
    """For each of ``model.parameters()``: whether the JAX optimizer decays it,
    i.e. whether its Flax leaf is a convolution's "kernel"."""
    kernels = {key for key, path, _ in flax_leaves(model) if path[-1] == "kernel"}
    return [name in kernels for name, _ in model.named_parameters()]
