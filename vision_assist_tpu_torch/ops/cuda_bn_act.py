"""The segmenter's ConvBNAct epilogue as one hand-written CUDA kernel for
Hopper (sm_90a): BatchNorm with the running statistics in float32, SiLU where
the block has it, and the cast back to the convolution's dtype, one pass over
device memory instead of four (see ``csrc/bn_act.cu`` for the design and what
bounds it).

It replaces no Pallas kernel: the JAX package's ``ConvBNAct``
(``vision_assist_tpu/models/yolo.py``) leaves ``nn.BatchNorm``, ``nn.silu``
and ``astype`` to XLA, which fuses them. The arithmetic is Flax's order:

    mul = weight / sqrt(var + eps)
    y   = (x - mean) * mul + bias
    y   = y / (1 + exp(-y))          where act

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). It launches on the current stream, so CUDA graphs capture it. The
call is the operator ``vision_assist_tpu_torch::bn_act`` on every device, so
``torch.export`` traces the model through it (a program exported from the
port holds it; import this module before loading one). On CPU tensors the
operator runs the plain twin, ``bn_act_plain``; on CUDA tensors it launches
the kernel or raises — it never falls back.

``bn_act_into`` is the same epilogue stored where its readers want it: into
``out``, a channels_last view of the input's shape (a channel slice of a
wider channels_last buffer, the concatenation a block feeds its next
convolution), and, where ``also`` is given, channels ``[also_from, C)`` into
that contiguous channels_last tensor as well, from the same registers in the
same launch. It raises on a view the kernel's 16-byte stores do not fit; it
never computes elsewhere and copies.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "bn_act.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MAX_CHANNELS = 4096   # kMaxTableChannels in csrc/bn_act.cu: a CTA's table

# Kernel launches since the last reset_launches(); one per operator call on
# CUDA tensors.
launches = 0
# Calls of bn_act_into since the last reset_launches(): kernel launches that
# stored into a view on the card, the twin and its copies on the CPU.
view_stores = 0

_lib = None
build_log = ""
build_seconds = 0.0
compiled = False       # False when build() reused an earlier build's library


def reset_launches() -> None:
    global launches, view_stores
    launches = view_stores = 0


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_log, build_seconds, compiled
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib_path, build_log, compiled = compile_shared(
        nvcc(), NVCC_FLAGS, SOURCE, "bn_act")
    lib = ctypes.CDLL(str(lib_path))
    lib.bn_act_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bn_act_launch.restype = ctypes.c_int
    lib.bn_act_into_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int]
    lib.bn_act_into_launch.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def bn_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float,
                 act: bool) -> torch.Tensor:
    """The kernel's plain twin: (N, C, H, W) ``x`` in any float dtype ->
    BatchNorm by the running statistics, in float32, in Flax's order, SiLU
    where ``act``, in ``x``'s dtype and memory format."""
    shape = (-1, 1, 1)
    mul = weight / torch.sqrt(var + eps)
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    if act:
        y = y / (1 + torch.exp(-y))
    return y.to(x.dtype)


def _check(x, weight, bias, mean, var) -> bool:
    """Raises unless ``x`` is (N, C, H, W), channels_last or contiguous NCHW,
    with statistics of C each, and, on the card, in what the kernel takes;
    returns whether ``x`` is channels_last."""
    if x.dim() != 4:
        raise ValueError(f"bn_act: x must be (N, C, H, W), not {tuple(x.shape)}")
    c = x.shape[1]
    if any(p.shape != (c,) for p in (weight, bias, mean, var)):
        raise ValueError(f"bn_act: {c} channels, statistics of shapes "
                         f"{[tuple(p.shape) for p in (weight, bias, mean, var)]}")
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    if not channels_last and not x.is_contiguous():
        raise ValueError(f"bn_act: strides {x.stride()} of shape {tuple(x.shape)} are "
                         "neither channels_last nor contiguous NCHW")
    if x.device.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"bn_act: the kernel takes bfloat16 or float32, not {x.dtype}")
        if any(p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous()
               for p in (weight, bias, mean, var)):
            raise ValueError("bn_act: the kernel takes contiguous float32 statistics on "
                             "the input's device")
        if c > MAX_CHANNELS:
            raise ValueError(f"bn_act: {c} channels; the kernel takes at most "
                             f"{MAX_CHANNELS}")
    return channels_last


def _stream(dev: torch.device) -> tuple[int, int]:
    """The card's index and the raw handle of its current stream, read
    through torch's C binding without building a Stream object: the
    segmenter launches the epilogue 90 to 214 times a forward, and the host
    issuing them sets the served cells' pace."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def _impl(x, weight, bias, mean, var, eps, act):
    global launches
    channels_last = _check(x, weight, bias, mean, var)
    if x.device.type == "cpu":
        return bn_act_plain(x, weight, bias, mean, var, eps, act)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build()
    _, c, h, w = x.shape
    index, stream = _stream(x.device)
    err = lib.bn_act_launch(x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                            bias.data_ptr(), mean.data_ptr(), var.data_ptr(), eps,
                            x.numel(), c, h * w, int(channels_last),
                            int(x.dtype == torch.bfloat16), int(act), index, stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: error {err} (shape "
                           f"{tuple(x.shape)}, {x.dtype})")
    launches += 1
    return out


PACK_BYTES = 16       # kPackBytes in csrc/bn_act.cu: a thread's load and store


def _check_into(x, weight, bias, mean, var, out, also, also_from) -> int:
    """Raises unless ``x`` is channels_last and ``out`` a channels_last view
    of its shape and dtype that the kernel's 16-byte stores fit (channel
    stride 1, a pixel stride of a whole number of packs, at a 16-byte
    offset), and ``also`` None or a channels_last tensor of ``x``'s channels
    from ``also_from`` on, a whole number of packs; returns the pixel stride
    of ``out``. The same on every device, so the CPU holds a model to what
    the card takes."""
    channels_last = _check(x, weight, bias, mean, var)
    n, c, h, w = x.shape
    pack = PACK_BYTES // x.element_size()
    if not channels_last:
        raise ValueError(f"bn_act_into: x must be channels_last, not strides {x.stride()}")
    if c % pack:
        raise ValueError(f"bn_act_into: {c} channels are not a whole number of "
                         f"{pack}-element packs")
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"bn_act_into: out {tuple(out.shape)} {out.dtype} on {out.device} "
                         f"for x {tuple(x.shape)} {x.dtype} on {x.device}")
    pixel = out.stride(3)
    if out.stride() != (h * w * pixel, 1, w * pixel, pixel) or pixel < c:
        raise ValueError(f"bn_act_into: out strides {out.stride()} are not a channels_last "
                         f"view of shape {tuple(out.shape)}")
    if pixel % pack or out.storage_offset() % pack:
        raise ValueError(f"bn_act_into: out at offset {out.storage_offset()} with pixel "
                         f"stride {pixel} is off the {PACK_BYTES}-byte pack")
    if also is not None:
        if not 0 <= also_from < c or also_from % pack:
            raise ValueError(f"bn_act_into: also from channel {also_from} of {c} is off "
                             f"the {PACK_BYTES}-byte pack")
        if (also.shape != (n, c - also_from, h, w) or also.dtype != x.dtype
                or also.device != x.device or also.storage_offset() % pack
                or not also.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"bn_act_into: also {tuple(also.shape)} {also.dtype}, strides "
                             f"{also.stride()}, is not channels [{also_from}, {c}) of x "
                             "in channels_last")
    return pixel


def _impl_into(x, weight, bias, mean, var, eps, act, out, also, also_from):
    global launches, view_stores
    pixel = _check_into(x, weight, bias, mean, var, out, also, also_from)
    if x.device.type == "cpu":
        y = bn_act_plain(x, weight, bias, mean, var, eps, act)
        out.copy_(y)
        if also is not None:
            also.copy_(y[:, also_from:])
        view_stores += 1
        return
    if x.numel() == 0:
        return
    src, dst = x.data_ptr(), out.data_ptr()
    also_ptr = also.data_ptr() if also is not None else 0
    if (src | dst | also_ptr) % PACK_BYTES:
        raise ValueError("bn_act_into: an address off the 16-byte pack")
    lib = build()
    _, c, h, w = x.shape
    index, stream = _stream(x.device)
    err = lib.bn_act_into_launch(
        src, dst, weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(), eps,
        x.numel(), c, h * w, int(x.dtype == torch.bfloat16), int(act), index, stream, pixel,
        also_ptr or None, also_from if also is not None else 0)
    if err != 0:
        raise RuntimeError(f"bn_act_into kernel launch failed: error {err} (shape "
                           f"{tuple(x.shape)}, {x.dtype}, pixel stride {pixel})")
    launches += 1
    view_stores += 1


# A plain operator definition: its dispatch costs a few microseconds a call,
# a fifth of torch.library.custom_op's, and the segmenter calls it 90 times a
# forward. The checks run in the fake implementation too, so a program traced
# for the card raises where the card would.
_LIB = torch.library.Library("vision_assist_tpu_torch", "FRAGMENT")
_LIB.define("bn_act(Tensor x, Tensor weight, Tensor bias, Tensor mean, Tensor var, "
            "float eps, bool act) -> Tensor")
_LIB.impl("bn_act", _impl, "CPU")
_LIB.impl("bn_act", _impl, "CUDA")
_LIB.define("bn_act_into(Tensor x, Tensor weight, Tensor bias, Tensor mean, Tensor var, "
            "float eps, bool act, Tensor(a!) out, Tensor(b!)? also, int also_from) -> ()")
_LIB.impl("bn_act_into", _impl_into, "CPU")
_LIB.impl("bn_act_into", _impl_into, "CUDA")


@torch.library.register_fake("vision_assist_tpu_torch::bn_act")
def _(x, weight, bias, mean, var, eps, act):
    _check(x, weight, bias, mean, var)
    return torch.empty_like(x)


@torch.library.register_fake("vision_assist_tpu_torch::bn_act_into")
def _(x, weight, bias, mean, var, eps, act, out, also, also_from):
    _check_into(x, weight, bias, mean, var, out, also, also_from)


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           mean: torch.Tensor, var: torch.Tensor, eps: float,
           act: bool) -> torch.Tensor:
    """(N, C, H, W) ``x``, channels_last or contiguous NCHW, and the
    BatchNorm's ``weight``, ``bias``, running ``mean`` and ``var`` of C each
    -> the epilogue in ``x``'s dtype and memory format. On the CPU the plain
    twin; on the card one launch of the kernel, which takes bf16 or float32
    ``x`` and float32 statistics. Raises on any other layout, shape or
    dtype."""
    return torch.ops.vision_assist_tpu_torch.bn_act(x, weight, bias, mean, var,
                                                    float(eps), bool(act))


def bn_act_into(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor, eps: float, act: bool,
                out: torch.Tensor, also: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`bn_act` of channels_last ``x`` stored into ``out``, a
    channels_last view of ``x``'s shape (a channel slice of a wider
    channels_last buffer), and, where ``also`` is given, its last
    ``also.shape[1]`` channels into ``also`` too (a contiguous channels_last
    tensor): one launch on the card. Every channel count, the slice's offset
    and its buffer's width must be whole 16-byte packs (8 bf16, 4 float32).
    Returns ``out``."""
    also_from = x.shape[1] - also.shape[1] if also is not None else 0
    torch.ops.vision_assist_tpu_torch.bn_act_into(x, weight, bias, mean, var, float(eps),
                                                  bool(act), out, also, also_from)
    return out
