"""Plain float32 SegFormer forward, the benchmark's reference for the
configurations that name ``"reference": "segformer"``: a per-pixel class
head (``"head": "semantic"``) whose output is ``logits`` (S, K, h, w).

Sources: Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers", arXiv:2105.15203 (MiT-B5 and the
All-MLP decoder, 768 wide at B2-B5); Hugging Face's checkpoint
``nvidia/segformer-b5-finetuned-cityscapes-1024-1024`` (19 Cityscapes
classes, ``decoder_hidden_size`` 768) and the modules and leaf names of its
``SegformerForSemanticSegmentation``
(``segformer.encoder.block.2.17.attention.self.sr``,
``decode_head.linear_c.3.proj``), so that the checkpoint, converted, loads
here and into the program alike and computes what it computes there.

Written from those sources, not from the program, every convolution,
Linear layer and matmul in float32 (the caller turns TF32 off):

* the input, RGB in [0, 1], normalised by ImageNet's mean and SD;
* four stages, each an overlapping patch embedding (a convolution, 7x7 at
  stride 4 with padding 3, then 3x3 at stride 2 with padding 1; a
  LayerNorm), pre-norm blocks ``x + attn(LN(x))``, ``x + MixFFN(LN(x))``,
  and a closing LayerNorm; widths 64/128/320/512, depths 3/6/40/3, heads
  1/2/5/8 of 64 at B5;
* efficient self-attention: queries from every token, keys and values from
  a stride-R RxR convolution of the tokens' grid and a LayerNorm (R =
  8/4/2/1, none where R is 1); softmax(q kᵀ / √64) v written as two
  matmuls and a softmax, the frames ``FRAMES_A_BLOCK`` at a time so that
  stage 1's 65,536 x 1,024 scores of a frame at 1024 fit; the output
  projection;
* Mix-FFN: Linear C -> 4C, a 3x3 depthwise convolution with bias, the
  exact (erf) GELU, Linear 4C -> C;
* the decoder: each stage's tokens by a Linear to 768, upsampled
  bilinearly to stride 4 (``align_corners=False``), concatenated stage 4
  first, a 1x1 convolution 3072 -> 768 without bias, BatchNorm, ReLU, a 1x1
  classifier;
* LayerNorm eps 1e-5 in every LayerNorm, as Hugging Face's modules have
  it (the paper's code uses 1e-6 in the blocks and the stages' closing
  norms), BatchNorm eps 1e-5.

Departures from the published model, each the pipeline's: the square
letterbox with grey-114 padding that every configuration's frames go
through, in place of the paper's Cityscapes evaluation (the 1024x2048
frame in 1024x1024 sliding windows); seeded weights (``harness/weights.py``); served in bf16 by
the program. The forward has no step that depends on the data, so it runs
on the meta device (``harness/peaks.py::model_flops``, ``harness/esa.py``).

``quant``: applied to every convolution's and Linear's operands and to
both attention products' (``None`` is the reference; the precision control
passes a rounding to float8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SPECS = {
    "segformer-b5": {"widths": (64, 128, 320, 512), "depths": (3, 6, 40, 3),
                     "heads": (1, 2, 5, 8), "reductions": (8, 4, 2, 1), "decoder": 768},
}
PATCHES = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))   # kernel, stride, padding
MLP_RATIO = 4
LN_EPS = 1e-5
BN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FRAMES_A_BLOCK = 1


@dataclasses.dataclass
class Outputs:
    logits: torch.Tensor


def _q(quant, x):
    return x if quant is None else quant(x)


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        return F.linear(_q(self.quant, x), _q(self.quant, self.weight), self.bias)


class Conv2d(nn.Conv2d):
    quant = None

    def forward(self, x):
        return F.conv2d(_q(self.quant, x), _q(self.quant, self.weight), self.bias,
                        self.stride, self.padding, 1, self.groups)


def _grid(tokens, h, w):
    """(B, N, C) -> (B, C, h, w)."""
    return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, h, w)


def _flat(grid):
    """(B, C, h, w) -> (B, N, C)."""
    return grid.flatten(2).transpose(1, 2)


class OverlapPatchEmbeddings(nn.Module):
    def __init__(self, c_in, c_out, kernel, stride, padding):
        super().__init__()
        self.proj = Conv2d(c_in, c_out, kernel, stride, padding)
        self.layer_norm = nn.LayerNorm(c_out, eps=LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        return self.layer_norm(_flat(x)), x.shape[2], x.shape[3]


class EfficientSelfAttention(nn.Module):
    """softmax(q kᵀ / √hd) v in heads of ``head_dim``, q from the tokens,
    k and v from the grid reduced by ``sr_ratio``."""

    def __init__(self, dim, num_heads, sr_ratio):
        super().__init__()
        self.num_heads, self.head_dim, self.sr_ratio = num_heads, dim // num_heads, sr_ratio
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.layer_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.quant = None

    def forward(self, x, h, w):
        b, n, c = x.shape
        y = x if self.sr_ratio == 1 else self.layer_norm(_flat(self.sr(_grid(x, h, w))))

        def heads(t):                                      # (B, T, C) -> (B, nh, T, hd)
            return t.reshape(b, -1, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(y)), heads(self.value(y))
        qn, out = self.quant, []
        for i in range(0, b, FRAMES_A_BLOCK):
            s = slice(i, i + FRAMES_A_BLOCK)
            scores = torch.matmul(_q(qn, q[s]), _q(qn, k[s]).transpose(-2, -1))
            p = torch.softmax(scores * self.head_dim ** -0.5, dim=-1)
            out.append(torch.matmul(_q(qn, p), _q(qn, v[s])))
        return torch.cat(out).transpose(1, 2).reshape(b, n, c)


class SelfOutput(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dense = Linear(dim, dim)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, sr_ratio):
        super().__init__()
        self.self = EfficientSelfAttention(dim, num_heads, sr_ratio)
        self.output = SelfOutput(dim)

    def forward(self, x, h, w):
        return self.output.dense(self.self(x, h, w))


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, h, w):
        return _flat(self.dwconv(_grid(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.dense1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.dense2 = Linear(hidden, dim)

    def forward(self, x, h, w):
        return self.dense2(F.gelu(self.dwconv(self.dense1(x), h, w)))


class Layer(nn.Module):
    def __init__(self, dim, num_heads, sr_ratio):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = Attention(dim, num_heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MixFFN(dim, MLP_RATIO * dim)

    def forward(self, x, h, w):
        x = x + self.attention(self.layer_norm_1(x), h, w)
        return x + self.mlp(self.layer_norm_2(x), h, w)


class Encoder(nn.Module):
    def __init__(self, spec):
        super().__init__()
        widths = spec["widths"]
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbeddings(3 if i == 0 else widths[i - 1], widths[i], *PATCHES[i])
            for i in range(len(widths)))
        self.block = nn.ModuleList(
            nn.ModuleList(Layer(widths[i], spec["heads"][i], spec["reductions"][i])
                          for _ in range(spec["depths"][i]))
            for i in range(len(widths)))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in widths)

    def forward(self, x):
        """Each stage's output grid (B, C_i, H_i, W_i)."""
        feats = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block, self.layer_norm):
            x, h, w = embed(x)
            for layer in blocks:
                x = layer(x, h, w)
            x = _grid(norm(x), h, w)
            feats.append(x)
        return feats


class Backbone(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.encoder = Encoder(spec)


class MLP(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.proj = Linear(c_in, c_out)


class DecodeHead(nn.Module):
    def __init__(self, spec, num_classes):
        super().__init__()
        d = spec["decoder"]
        self.linear_c = nn.ModuleList(MLP(c, d) for c in spec["widths"])
        self.linear_fuse = Conv2d(len(spec["widths"]) * d, d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d, eps=BN_EPS)
        self.classifier = Conv2d(d, num_classes, 1)

    def forward(self, feats):
        size = feats[0].shape[2:]
        maps = []
        for x, mlp in reversed(list(zip(feats, self.linear_c))):     # stage 4 first
            y = _grid(mlp.proj(_flat(x)), x.shape[2], x.shape[3])
            maps.append(F.interpolate(y, size=size, mode="bilinear", align_corners=False))
        x = F.relu(self.batch_norm(self.linear_fuse(torch.cat(maps, dim=1))))
        return self.classifier(x)


class SegFormer(nn.Module):
    """``arch``: a name of ``SPECS`` or a dict of its keys."""

    def __init__(self, arch, num_classes):
        super().__init__()
        spec = SPECS[arch] if isinstance(arch, str) else arch
        self.segformer = Backbone(spec)
        self.decode_head = DecodeHead(spec, num_classes)

    def forward(self, images):
        mean, std = (torch.tensor(v, device=images.device).view(1, 3, 1, 1) for v in (MEAN, STD))
        feats = self.segformer.encoder((images - mean) / std)
        return Outputs(self.decode_head(feats))


def build_model(config: dict) -> SegFormer:
    """The float32 model of a configuration."""
    return SegFormer(config["arch"], config["num_classes"])


def set_quant(model: nn.Module, quant) -> None:
    """Apply ``quant`` to every convolution's, Linear's and attention
    product's operands (None: the reference itself)."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant


def flax_leaves(model: nn.Module) -> list[tuple[str, tuple[str, ...], str]]:
    """(state-dict key, Flax path, layout) of every leaf in creation order:
    each module holding weights under its Hugging Face name."""
    out = []
    for name, m in model.named_modules():
        p, s = ("params", name), ("batch_stats", name)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            layout = "conv" if isinstance(m, nn.Conv2d) else "dense"
            out.append((f"{name}.weight", p + ("kernel",), layout))
            if m.bias is not None:
                out.append((f"{name}.bias", p + ("bias",), "same"))
        elif isinstance(m, nn.LayerNorm):
            out += [(f"{name}.weight", p + ("scale",), "layer_norm"),
                    (f"{name}.bias", p + ("bias",), "same")]
        elif isinstance(m, nn.BatchNorm2d):
            out += [(f"{name}.weight", p + ("scale",), "same"),
                    (f"{name}.bias", p + ("bias",), "same"),
                    (f"{name}.running_mean", s + ("mean",), "same"),
                    (f"{name}.running_var", s + ("var",), "same")]
    return out


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    state = {}
    for key, path, layout in flax_leaves(model):
        value = np.asarray(variables[path[0]][path[1]][path[2]], np.float32)
        if layout == "conv":
            value = value.transpose(3, 2, 0, 1)
        elif layout == "dense":
            value = value.T
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"leaves missing {missing[:5]} or left over {unexpected[:5]}")
