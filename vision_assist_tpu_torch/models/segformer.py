"""PyTorch SegFormer, a per-pixel class head: the Mix Transformer encoder
(MiT) and the All-MLP decoder; ``ARCHS`` maps each name to its widths.

Sources: Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers", arXiv:2105.15203 (MiT-B5, the decoder
width 768 of B2-B5); Hugging Face's checkpoint
``nvidia/segformer-b5-finetuned-cityscapes-1024-1024`` (``segformer-b5``,
19 Cityscapes classes, of which train id 1 is the sidewalk) and its
``SegformerForSemanticSegmentation``, whose modules this one computes. The
JAX package has no SegFormer: the model this one is held to is the
benchmark's plain reference, ``benchmark/reference/segformer.py``.

The encoder has four stages. Each is an overlapping patch embedding (a
convolution, 7x7 at stride 4 with padding 3 for the first stage, 3x3 at
stride 2 with padding 1 for the others, then a LayerNorm), pre-norm blocks
``x + attn(LN(x))`` then ``x + MixFFN(LN(x))``, and a closing LayerNorm.
Efficient self-attention takes its queries from every token and its keys
and values from a stride-R RxR convolution of the tokens' grid and a
LayerNorm (none where R is 1), in heads of 64 at the scale 64^-0.5;
Mix-FFN is a Linear C -> 4C, a 3x3 depthwise convolution with bias, the
exact (erf) GELU and a Linear 4C -> C. The decoder takes each stage's
tokens by a Linear to 768 channels, upsamples them bilinearly to stride 4
(``align_corners=False``), concatenates them stage 4 first, and ends in a
1x1 convolution 3072 -> 768 without bias, BatchNorm, ReLU and a 1x1
classifier. LayerNorm eps 1e-5 in every LayerNorm, as Hugging Face's
modules have it (the paper's code uses 1e-6 in the blocks and the stages'
closing norms), BatchNorm eps 1e-5. The input, RGB in [0, 1] as the
letterbox gives it, is normalised by ImageNet's mean and SD, as the
checkpoint's image processor does.

Serving arithmetic: Linear, convolution and attention operands in the
compute dtype (bf16 on the card) with float32 accumulation; LayerNorm
statistics in float32 (ATen's kernels accumulate so); the decoder's
BatchNorm in float32, one launch of the epilogue kernel (``bn_act``); the
classifier and the logits in float32. Tokens are channels-last: a stage's
activations are one (B, H, W, C) tensor, so the tokens (B, H * W, C) and
the grid (B, C, H, W) in channels_last, which the convolutions take, are
views of it. The attention is one ``F.scaled_dot_product_attention`` a
block on the pinned kernel (``ops/attention.py``), q (B, heads, N, 64)
against k and v (B, heads, N / R², 64), all three views of their Linear's
output; key and value are one Linear (their weights stacked at load).

The weights come as a Flax-layout tree ({"params", "batch_stats"}) whose
paths are Hugging Face's ``SegformerForSemanticSegmentation`` state-dict
names (``segformer.encoder.block.2.17.attention.self.sr``,
``decode_head.linear_c.3.proj``): :func:`load_flax_variables`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from vision_assist_tpu_torch.ops.attention import sdpa_backend
from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act
from vision_assist_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class MitSpec:
    """A SegFormer's sizes: each stage's width, blocks, heads and key
    reduction R, the Mix-FFN's expansion and the decoder's width."""
    widths: tuple[int, ...]
    depths: tuple[int, ...]
    heads: tuple[int, ...]
    reductions: tuple[int, ...]
    mlp_ratio: int = 4
    decoder: int = 768


ARCHS = {
    "segformer-b5": MitSpec(widths=(64, 128, 320, 512), depths=(3, 6, 40, 3),
                            heads=(1, 2, 5, 8), reductions=(8, 4, 2, 1)),
}
# (kernel, stride, padding) of each stage's patch embedding.
PATCHES = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))
LN_EPS = 1e-5
BN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# Attention calls since the last reset_esa_calls(): one an efficient
# self-attention block a forward, 52 at segformer-b5.
esa_calls = 0


def reset_esa_calls() -> None:
    global esa_calls
    esa_calls = 0


@dataclasses.dataclass
class SegFormerOutputs:
    logits: torch.Tensor     # (B, classes, H / 4, W / 4) float32


def _grid(tokens: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> its (B, C, H, W) view, channels_last where the
    tokens are contiguous."""
    return tokens.permute(0, 3, 1, 2)


def _tokens(grid: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> its (B, H, W, C) view."""
    return grid.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, padding: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(c_in, c_out, kernel, stride, padding, dtype=dtype)
        self.norm = nn.LayerNorm(c_out, eps=LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_tokens(self.proj(x)))


class EfficientSelfAttention(nn.Module):
    """Queries from every token; keys and values from the tokens' grid
    reduced by a stride-R RxR convolution and a LayerNorm (R > 1), or from
    the tokens (R = 1); then the output projection."""

    def __init__(self, dim: int, heads: int, reduction: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim, dtype=dtype)
        self.kv = nn.Linear(dim, 2 * dim, dtype=dtype)        # [key | value]
        self.sr = self.sr_norm = None
        if reduction > 1:
            self.sr = nn.Conv2d(dim, dim, reduction, reduction, dtype=dtype)
            self.sr_norm = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) normalised tokens -> (B, H, W, C)."""
        global esa_calls
        with spans.span("program.segment.esa"):
            b, h, w, c = x.shape
            nh = self.heads
            q = self.q(x).view(b, h * w, nh, c // nh).transpose(1, 2)
            y = x if self.sr is None else self.sr_norm(_tokens(self.sr(_grid(x))))
            kv = self.kv(y).view(b, -1, 2, nh, c // nh)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            with sdpa_kernel(sdpa_backend(q)):
                out = F.scaled_dot_product_attention(q, k, v)    # (B, nh, N, hd)
            esa_calls += 1
            return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.dw = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(_tokens(self.dw(_grid(self.fc1(x))))))


class MitBlock(nn.Module):
    def __init__(self, dim: int, heads: int, reduction: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.attn = EfficientSelfAttention(dim, heads, reduction, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ffn = MixFFN(dim, mlp_ratio * dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class MitStage(nn.Module):
    def __init__(self, spec: MitSpec, i: int, dtype: torch.dtype):
        super().__init__()
        c_in = 3 if i == 0 else spec.widths[i - 1]
        dim = spec.widths[i]
        self.patch = PatchEmbed(c_in, dim, *PATCHES[i], dtype=dtype)
        self.blocks = nn.ModuleList(
            MitBlock(dim, spec.heads[i], spec.reductions[i], spec.mlp_ratio, dtype)
            for _ in range(spec.depths[i]))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, H, W) -> the stage's (B, H', W', C) tokens."""
        x = self.patch(x)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class AllMLPDecoder(nn.Module):
    """Each stage's tokens by a Linear to ``width``, upsampled to the first
    stage's grid, concatenated in ``ORDER``; a 1x1 convolution, BatchNorm,
    ReLU and the classifier."""

    ORDER = (3, 2, 1, 0)        # the concatenation: stage 4's map first

    def __init__(self, widths: tuple[int, ...], width: int, num_classes: int,
                 dtype: torch.dtype):
        super().__init__()
        self.linear_c = nn.ModuleList(nn.Linear(c, width, dtype=dtype) for c in widths)
        self.fuse = nn.Conv2d(len(widths) * width, width, 1, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(width, eps=BN_EPS)
        self.classifier = nn.Conv2d(width, num_classes, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Each stage's (B, H_i, W_i, C_i) tokens -> (B, classes, H_0, W_0)
        float32 logits."""
        size = feats[0].shape[1:3]
        maps = []
        for i in self.ORDER:
            y = self.linear_c[i](feats[i])
            if y.shape[1:3] != size:
                y = _tokens(F.interpolate(_grid(y), size=size, mode="bilinear",
                                          align_corners=False))
            maps.append(y)
        fuse = self.fuse.weight
        y = F.linear(torch.cat(maps, dim=-1), fuse.view(fuse.shape[:2]))
        bn = self.bn
        y = torch.relu_(bn_act(_grid(y), bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, bn.eps, False))
        cls = self.classifier
        z = F.linear(_tokens(y).float(), cls.weight.view(cls.weight.shape[:2]), cls.bias)
        return _grid(z)


class SegFormer(nn.Module):
    """SegFormer of ``arch`` (a name of ``ARCHS``, or a ``MitSpec``);
    images (B, 3, H, W) float RGB in [0, 1] -> ``SegFormerOutputs``.
    ``dtype`` is the compute dtype; the decoder's BatchNorm and the
    classifier are float32 either way."""

    def __init__(self, arch: str | MitSpec = "segformer-b5", num_classes: int = 19,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if isinstance(arch, MitSpec):
            spec = arch
        elif arch in ARCHS:
            spec = ARCHS[arch]
        else:
            raise ValueError(f"SegFormer: no architecture {arch!r}; one of {sorted(ARCHS)}")
        self.spec, self.dtype = spec, dtype
        self.stages = nn.ModuleList(MitStage(spec, i, dtype) for i in range(len(spec.widths)))
        self.decoder = AllMLPDecoder(spec.widths, spec.decoder, num_classes, dtype)
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, images: torch.Tensor) -> SegFormerOutputs:
        x = ((images.float() - self.mean) / self.std).to(self.dtype)
        feats = []
        for stage in self.stages:
            feats.append(stage(x))
            x = _grid(feats[-1])
        with spans.span("program.segment.decoder"):
            return SegFormerOutputs(logits=self.decoder(feats))


def flax_names(model: SegFormer) -> list[tuple[str, nn.Module, slice | None]]:
    """(Hugging Face's name of a module holding weights, the port's module,
    the rows of the port's output it fills, or None for all) in the tree's
    order; the key and the value fill the two halves of one Linear."""
    out = []
    enc = "segformer.encoder"
    for i, stage in enumerate(model.stages):
        out += [(f"{enc}.patch_embeddings.{i}.proj", stage.patch.proj, None),
                (f"{enc}.patch_embeddings.{i}.layer_norm", stage.patch.norm, None)]
        for j, block in enumerate(stage.blocks):
            p, a = f"{enc}.block.{i}.{j}", block.attn
            c = a.q.out_features
            out += [(f"{p}.layer_norm_1", block.norm1, None),
                    (f"{p}.attention.self.query", a.q, None),
                    (f"{p}.attention.self.key", a.kv, slice(0, c)),
                    (f"{p}.attention.self.value", a.kv, slice(c, 2 * c))]
            if a.sr is not None:
                out += [(f"{p}.attention.self.sr", a.sr, None),
                        (f"{p}.attention.self.layer_norm", a.sr_norm, None)]
            out += [(f"{p}.attention.output.dense", a.proj, None),
                    (f"{p}.layer_norm_2", block.norm2, None),
                    (f"{p}.mlp.dense1", block.ffn.fc1, None),
                    (f"{p}.mlp.dwconv.dwconv", block.ffn.dw, None),
                    (f"{p}.mlp.dense2", block.ffn.fc2, None)]
        out.append((f"{enc}.layer_norm.{i}", stage.norm, None))
    d = model.decoder
    out += [(f"decode_head.linear_c.{i}.proj", m, None) for i, m in enumerate(d.linear_c)]
    out += [("decode_head.linear_fuse", d.fuse, None), ("decode_head.batch_norm", d.bn, None),
            ("decode_head.classifier", d.classifier, None)]
    return out


def load_flax_variables(model: SegFormer, variables: dict) -> None:
    """Load a Flax-layout tree whose paths are Hugging Face's names
    (``flax_names``): a convolution's kernel HWIO, a Linear's (in, out), a
    norm's ``scale`` and ``bias``, a BatchNorm's running ``mean`` and ``var``
    under ``batch_stats``. Raises on a leaf missing or left over."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    names = flax_names(model)
    unused = set(params) | set(stats)
    unused -= {n for n, _, _ in names}
    if unused:
        raise ValueError(f"SegFormer: leaves the model does not hold: {sorted(unused)[:5]}")

    def put(t: torch.Tensor, value, rows=None) -> None:
        t = t if rows is None else t[rows]
        t.copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))

    with torch.no_grad():
        for name, m, rows in names:
            p = params[name]
            if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                put(m.weight, p["scale"])
                if isinstance(m, nn.BatchNorm2d):
                    put(m.running_mean, stats[name]["mean"])
                    put(m.running_var, stats[name]["var"])
            else:
                kernel = np.asarray(p["kernel"])
                put(m.weight, kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T,
                    rows)
            if m.bias is not None:
                put(m.bias, p["bias"], rows)
