"""The data-parallel train step: the single-process step on the global batch.

The JAX package gets it from ``jit`` over a dp-sharded batch: XLA turns
every batch-wide reduction into a global one. Here each rank runs
``models/train.py``'s step on its own rows, and the collectives make the same
reductions global:

* train-mode BatchNorm normalises by the global batch's statistics: its
  per-channel sums are all-reduced (differentiably) over the ranks that split
  the batch, so mean and biased variance are the global batch's;
* the loss normalisers (the target-score sum, the foreground count) and the
  batch size are all-reduced before they divide; each rank's loss is then its
  share of the global loss;
* the flat gradient is all-reduced once, before ``NesterovSGD`` zeroes its
  non-finite entries and clips its norm, so every rank takes the same update
  and keeps the same EMA.

With mdl > 1 each kernel that ``mesh.param_partition_spec`` splits is stored
on each rank as its slice of the output channels, and all-gathered whole
before its convolution (``mesh.shard_params``); its gradient is the slice of
the whole kernel's. The ranks of one mdl group see the same rows, the
gradient is summed over the dp group only, and the clipping norm adds the
slices' squared norms over the mdl group.

A dp group of one rank needs no statistics to be synchronised, so BatchNorm
is then the single-process one (as ``nn.SyncBatchNorm`` does); the loss and
gradient all-reduces still run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vision_assist_tpu_torch.models.train import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_optimizer,
)
from vision_assist_tpu_torch.models.yolo import ConvBNAct, YoloSeg, weight_decay_mask
from vision_assist_tpu_torch.parallel.distributed import process_info
from vision_assist_tpu_torch.parallel.mesh import Mesh, shard_params


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks of a group, differentiable: every rank's input
    feeds every rank's output, so the gradient is the sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class Collectives:
    """This rank's process groups on a (dp, mdl) mesh spanning the process
    group, and the sums the train step takes over them. Every rank must
    build it, in the same order relative to other groups."""

    def __init__(self, mesh: Mesh):
        rank, world = process_info()
        if not dist.is_initialized() or world != mesh.size:
            raise ValueError(f"the mesh has {mesh.size} positions for a process "
                             f"group of {world}")
        dp, mdl = mesh.shape["dp"], mesh.shape["mdl"]
        self.mesh, self.rank = mesh, rank
        self.dp_index, self.mdl_index = mesh.coords(rank)
        self.dp_group = self.mdl_group = None
        if mdl > 1:
            # new_group is collective: every rank creates every group.
            for j in range(mdl):
                g = dist.new_group([i * mdl + j for i in range(dp)])
                if j == self.mdl_index:
                    self.dp_group = g
            for i in range(dp):
                g = dist.new_group([i * mdl + j for j in range(mdl)])
                if i == self.dp_index:
                    self.mdl_group = g
        self.sliced: torch.Tensor | None = None     # flat mask of stored slices

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (without its gradient) summed over the dp group."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.dp_group)
        return t

    def grad_sum(self, g: torch.Tensor) -> None:
        """The flat gradient summed over the dp group, in place."""
        dist.all_reduce(g, group=self.dp_group)

    def bn_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A differentiable sum over the dp group (BatchNorm statistics)."""
        return _SumOverRanks.apply(t, self.dp_group)

    @property
    def sq_norm(self):
        """The whole gradient's squared norm from this rank's flat one, when
        kernels are stored as slices; else None (the plain norm)."""
        if self.sliced is None:
            return None

        def sq_norm(g: torch.Tensor) -> torch.Tensor:
            sq = g.square()
            part = sq[self.sliced].sum()
            dist.all_reduce(part, group=self.mdl_group)
            return sq[~self.sliced].sum() + part

        return sq_norm


def create_dp_train_state(model: YoloSeg, cfg: TrainConfig, steps_per_epoch: int,
                          mesh: Mesh, device: str | torch.device = "cuda"
                          ) -> tuple[TrainState, Collectives]:
    """``create_train_state`` for this rank of a process group that the
    mesh spans, from the same weights on every rank. With mdl > 1 the split
    kernels are stored as this rank's slices first. Returns the state and
    the collectives of its step: ``models.train.make_train_step(model,
    loss_cfg, cfg, collectives)`` is then this rank's step on its local rows
    of the global batch (the ranks' local batches concatenated in dp order),
    with the global batch's metrics on every rank."""
    coll = Collectives(mesh)
    # Storing a kernel as slices all-gathers it once, on the group's device.
    model.to(torch.device(device))
    decays = dict(zip((n for n, _ in model.named_parameters()),
                      weight_decay_mask(model)))
    split = shard_params(model, mesh, coll.rank, coll.mdl_group)
    if mesh.shape["dp"] > 1:
        for m in model.modules():
            if isinstance(m, ConvBNAct):
                m.global_sum = coll.bn_sum
    state = create_train_state(model, cfg, steps_per_epoch, device=device)
    if split:
        # A kernel stored as slices is the parametrization's "original"; it
        # decays as the whole kernel does.
        stored = {f"{n.removesuffix('.weight')}.parametrizations.weight.original": n
                  for n in split}
        state.tx = make_optimizer(cfg, steps_per_epoch,
                                  [decays[stored.get(n, n)] for n in state.params])
        coll.sliced = torch.cat([
            torch.full((p.numel(),), name in stored, dtype=torch.bool)
            for name, p in state.params.items()]).to(state.trace.device)
    return state, coll


@torch.no_grad()
def gathered_state_dict(model: YoloSeg) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` under its single-process names, each kernel
    stored as slices all-gathered whole (collective: every rank of the
    group calls it)."""
    out = {}
    for key, value in model.state_dict().items():
        if ".parametrizations." in key:
            module, attr = key.split(".parametrizations.")
            attr = attr.removesuffix(".original")
            value = getattr(model.get_submodule(module), attr)
            key = f"{module}.{attr}"
        out[key] = value.detach().clone()
    return out
