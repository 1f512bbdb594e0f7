"""A small device mesh and its sharding rules.

Counterpart of ``vision_assist_tpu/parallel/mesh.py``. A :class:`Mesh` is a
(dp, mdl) grid of torch devices:

  dp   data parallel: the batch or stream axis (camera streams in serving,
       images in training). ``MultiStreamProcessor(mesh=...)`` gives each dp
       row's device a contiguous shard of the streams; data-parallel training
       sums gradients over it with one all-reduce (``parallel/train_step.py``).
  mdl  model parallel: the output channels of the wide convolution kernels,
       and the prototype axis of the mask assembly (:func:`assemble_masks_mdl`).

Inside a process group (``parallel/distributed.py``) the mesh's positions are
the ranks in row-major order, rank r at (r // mdl, r % mdl); each rank holds
one device. Outside one, a mesh is a list of devices one process drives.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "mdl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, mdl) grid of devices: ``devices[i, j]`` is the device at data
    shard i and model shard j."""

    devices: np.ndarray                 # (dp, mdl) object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self, rank: int) -> tuple[int, int]:
        """(dp index, mdl index) of a flat position (a rank)."""
        return divmod(rank, self.devices.shape[1])


def _default_devices() -> list[torch.device]:
    """One device a rank inside a process group (its card under NCCL, the
    CPU under gloo), else every card of this process."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if dist.get_backend() == "nccl":
            n = torch.cuda.device_count()
            return [torch.device("cuda", r % n) for r in range(world)]
        return [torch.device("cpu")] * world
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices= (for "
                           "example [torch.device('cpu')] * n)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, mdl: int = 1,
              devices=None) -> Mesh:
    """Mesh of shape (dp, mdl) over the first n_devices devices."""
    if devices is None:
        devices = _default_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices")
    if n_devices % mdl:
        raise ValueError(f"n_devices={n_devices} not divisible by mdl={mdl}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(n_devices // mdl, mdl))


def param_partition_spec(path: str, value: Any, mdl_size: int,
                         cout_dim: int = 0) -> tuple[str | None, ...]:
    """Sharding rule for model parameters: a 4-D convolution kernel splits
    its output channels over 'mdl' when they divide and number at least
    2 * mdl; BatchNorm and biases replicate. With mdl=1 everything
    replicates (pure data parallel). ``cout_dim`` is where the output
    channels lie: 0 for ``nn.Conv2d``, 1 for ``nn.ConvTranspose2d``."""
    if mdl_size <= 1 or not hasattr(value, "ndim"):
        return ()
    if value.ndim == 4 and value.shape[cout_dim] % mdl_size == 0 \
            and value.shape[cout_dim] >= 2 * mdl_size:
        return (None,) * cout_dim + ("mdl",)
    return ()


class _GatherSlices(torch.autograd.Function):
    """All-gather the model-parallel slices of a kernel along ``dim``. The
    ranks of an mdl group run the same data through the same layers, so each
    gets the same gradient of the whole kernel and keeps its own slice."""

    @staticmethod
    def forward(ctx, piece, dim, index, n, group):
        ctx.dim, ctx.index, ctx.n = dim, index, n
        parts = [torch.empty_like(piece) for _ in range(n)]
        dist.all_gather(parts, piece.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.index], None, None, None, None


class _CoutSlice(torch.nn.Module):
    """A parametrization storing a kernel as this rank's slice of its output
    channels; reading the weight all-gathers the whole kernel."""

    def __init__(self, dim: int, index: int, n: int, group):
        super().__init__()
        self.dim, self.index, self.n, self.group = dim, index, n, group

    def forward(self, piece: torch.Tensor) -> torch.Tensor:
        return _GatherSlices.apply(piece, self.dim, self.index, self.n, self.group)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        return whole.chunk(self.n, self.dim)[self.index].clone()


def shard_params(model: torch.nn.Module, mesh: Mesh, rank: int,
                 mdl_group=None) -> list[str]:
    """Store, on this rank, each kernel that :func:`param_partition_spec`
    splits as its slice of the output channels (a parametrization; the
    weight read in the forward pass is the all-gathered whole over
    ``mdl_group``). Returns the names of the split kernels. With mdl=1
    nothing changes."""
    from torch.nn.utils import parametrize

    mdl = mesh.shape["mdl"]
    _, index = mesh.coords(rank)
    split = []
    for name, module in list(model.named_modules()):
        if not isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        dim = 1 if isinstance(module, torch.nn.ConvTranspose2d) else 0
        if param_partition_spec(name, module.weight, mdl, dim):
            parametrize.register_parametrization(
                module, "weight", _CoutSlice(dim, index, mdl, mdl_group))
            split.append(f"{name}.weight")
    return split


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Each entry of ``batch`` split over dp into equal contiguous pieces of
    its leading axis: a (dp, mdl) object array of pieces, each on its device
    (the positions of a dp row hold the same piece). ValueError when the
    leading axis does not split."""
    dp = mesh.shape["dp"]
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % dp:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over dp={dp}")
        pieces = np.empty(mesh.devices.shape, dtype=object)
        for (i, j), device in np.ndenumerate(mesh.devices):
            pieces[i, j] = v.chunk(dp)[i].to(device)
        out[k] = pieces
    return out


def proto_einsum_specs() -> tuple[tuple[str | None, ...], tuple[str | None, ...]]:
    """Where the mask assembly's operands split over 'mdl': the coefficients
    (D, nm) and the prototypes (nm, Hp, Wp) (the port's channel-first
    layout) on their shared contraction axis nm, so each rank holds nm/mdl
    prototypes and its slice of every coefficient vector, computes a partial
    (D, Hp, Wp) mask, and one all-reduce over mdl adds them
    (:func:`assemble_masks_mdl`). A spec names the mesh axis of each
    dimension, counted from the last, so a leading stream axis is left
    whole."""
    return (None, "mdl"), ("mdl", None, None)


def _mdl_piece(x: torch.Tensor, spec: tuple[str | None, ...], index: int,
               mdl: int) -> torch.Tensor:
    """Rank ``index``'s piece of ``x`` under ``spec``: the dimension that
    ``spec`` puts on 'mdl' cut into ``mdl`` equal contiguous pieces."""
    dim = x.dim() - len(spec) + spec.index("mdl")
    n = x.shape[dim]
    if n % mdl:
        raise ValueError(f"{n} does not split over mdl={mdl}")
    return x.narrow(dim, index * n // mdl, n // mdl)


def assemble_masks_mdl(protos: torch.Tensor, dets, input_hw: tuple[int, int],
                       mdl_index: int, mdl: int, group=None) -> torch.Tensor:
    """``models/decode.assemble_masks`` with its contraction split over the
    mdl ranks as :func:`proto_einsum_specs` says: this rank assembles from
    its ``nm / mdl`` prototypes (``protos`` (nm, Hp, Wp) and the
    coefficients' last axis, whole on every rank) and one all-reduce adds
    the partial (D, Hp, Wp) masks. The box crop multiplies by 0 or 1, so it
    commutes with the sum."""
    from vision_assist_tpu_torch.models.decode import assemble_masks

    coeff_spec, proto_spec = proto_einsum_specs()
    part = assemble_masks(
        _mdl_piece(protos, proto_spec, mdl_index, mdl),
        dataclasses.replace(dets, coeffs=_mdl_piece(dets.coeffs, coeff_spec,
                                                    mdl_index, mdl)),
        input_hw)
    if mdl > 1:
        dist.all_reduce(part, group=group)
    return part
