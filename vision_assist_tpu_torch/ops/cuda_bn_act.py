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

_lib = None
build_log = ""
build_seconds = 0.0
compiled = False       # False when build() reused an earlier build's library


def reset_launches() -> None:
    global launches
    launches = 0


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


def _impl(x, weight, bias, mean, var, eps, act):
    global launches
    channels_last = _check(x, weight, bias, mean, var)
    if x.device.type == "cpu":
        return bn_act_plain(x, weight, bias, mean, var, eps, act)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build()
    dev = x.device
    _, c, h, w = x.shape
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.bn_act_launch(x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                            bias.data_ptr(), mean.data_ptr(), var.data_ptr(), eps,
                            x.numel(), c, h * w, int(channels_last),
                            int(x.dtype == torch.bfloat16), int(act), index,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: error {err} (shape "
                           f"{tuple(x.shape)}, {x.dtype})")
    launches += 1
    return out


# A plain operator definition: its dispatch costs a few microseconds a call,
# a fifth of torch.library.custom_op's, and the segmenter calls it 90 times a
# forward. The checks run in the fake implementation too, so a program traced
# for the card raises where the card would.
_LIB = torch.library.Library("vision_assist_tpu_torch", "FRAGMENT")
_LIB.define("bn_act(Tensor x, Tensor weight, Tensor bias, Tensor mean, Tensor var, "
            "float eps, bool act) -> Tensor")
_LIB.impl("bn_act", _impl, "CPU")
_LIB.impl("bn_act", _impl, "CUDA")


@torch.library.register_fake("vision_assist_tpu_torch::bn_act")
def _(x, weight, bias, mean, var, eps, act):
    _check(x, weight, bias, mean, var)
    return torch.empty_like(x)


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
