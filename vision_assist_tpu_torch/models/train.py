"""Training: state, schedule, optimizer and the train step.

Counterpart of ``vision_assist_tpu/models/train.py``: SGD (Nesterov, momentum
0.937) with weight decay 5e-4 on convolution kernels only, after zeroing
non-finite gradients and clipping the global norm at 10 (the order of the JAX
``optax.chain``); linear warmup then linear decay of the learning rate; an EMA
of the parameters whose decay ramps up over the first steps. Parameters are
float32; the model computes in its own dtype (bf16 on the card).

The JAX step is a pure function that donates its state. Here the step updates
the state in place and returns it: ``state.params`` and ``state.batch_stats``
are the model's own tensors, so the model always holds the current weights.
The optimizer works on one flat float32 vector for the gradient and the
momentum, and ``torch._foreach_*`` for the parameters and the EMA, so a step
costs a few launches for them rather than a few for each of ~300 tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from vision_assist_tpu_torch.data.augment_device import hsv_jitter_rgb
from vision_assist_tpu_torch.models.losses import LossConfig, yolo_seg_loss
from vision_assist_tpu_torch.models.yolo import YoloSeg, weight_decay_mask
from vision_assist_tpu_torch.ops.yuv import i420_to_bgr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    batch_size: int = 16
    imgsz: int = 640
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    ema_decay: float = 0.9999
    ema_ramp: float = 2000.0
    # Batch image format: "bgr" ships (B, S, S, 3) uint8; "i420" the packed
    # (B, S*3/2, S) YUV 4:2:0 plane (half the bytes), converted on the device
    # as the serving path does (ops/yuv.py).
    wire_format: str = "bgr"


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate at an optimizer step: linear warmup from 0 over
    ``warmup_epochs``, then linear decay from lr0 to lr0 * lrf."""
    total = cfg.epochs * steps_per_epoch
    warmup = int(cfg.warmup_epochs * steps_per_epoch)

    def sched(step: int) -> float:
        if step < warmup:
            return cfg.lr0 * min(step / max(warmup, 1), 1.0)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return cfg.lr0 * ((1 - frac) + frac * cfg.lrf)

    return sched


# ultralytics clips the global gradient norm at 10 before stepping.
MAX_GRAD_NORM = 10.0


class NesterovSGD:
    """The JAX optimizer chain, in place on a list of float32 tensors:
    zero every non-finite gradient entry; clip to a global norm of
    MAX_GRAD_NORM with optax's formula g / |g| * MAX_GRAD_NORM (no epsilon,
    unlike ``clip_grad_norm_``); add ``weight_decay * param`` where
    ``decay_mask`` says so; Nesterov momentum (trace = g + m * trace, update =
    g + m * trace); step by the schedule's rate at the optimizer's step
    count."""

    def __init__(self, schedule: Callable[[int], float], momentum: float,
                 weight_decay: float, decay_mask: list[bool]):
        self.schedule, self.momentum = schedule, momentum
        self.weight_decay, self.decay_mask = weight_decay, decay_mask
        self._decay: torch.Tensor | None = None

    def init(self, params: list[torch.Tensor]) -> torch.Tensor:
        """The momentum trace: zeros, one flat float32 vector."""
        if len(params) != len(self.decay_mask):
            raise ValueError(f"{len(params)} parameters, {len(self.decay_mask)} "
                             "decay flags")
        n = sum(p.numel() for p in params)
        return torch.zeros(n, dtype=torch.float32, device=params[0].device)

    def _decay_vector(self, params: list[torch.Tensor]) -> torch.Tensor:
        if self._decay is None or self._decay.device != params[0].device:
            self._decay = torch.cat([
                torch.full((p.numel(),), self.weight_decay if m else 0.0,
                           dtype=torch.float32)
                for p, m in zip(params, self.decay_mask)]).to(params[0].device)
        return self._decay

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               trace: torch.Tensor, count: int, grad_sum=None,
               sq_norm=None) -> None:
        """One step: ``params`` and ``trace`` in place; ``count`` is the number
        of updates made before this one (the rate's step).

        Data-parallel training passes ``grad_sum``, which sums the flat
        gradient over the ranks in place (one all-reduce), and, where
        parameters are stored as slices over model-parallel ranks,
        ``sq_norm``, the squared norm of the whole gradient from this rank's
        flat one."""
        g = torch.cat([x.reshape(-1) for x in grads])
        if grad_sum is not None:
            grad_sum(g)
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        norm = (torch.linalg.vector_norm(g) if sq_norm is None
                else torch.sqrt(sq_norm(g)))
        g = torch.where(norm < MAX_GRAD_NORM, g, g / norm * MAX_GRAD_NORM)
        g.addcmul_(torch.cat([p.reshape(-1) for p in params]),
                   self._decay_vector(params))
        trace.mul_(self.momentum).add_(g)
        g.add_(trace, alpha=self.momentum)
        updates = [u.view_as(p) for u, p in
                   zip(torch.split(g, [p.numel() for p in params]), params)]
        torch._foreach_add_(params, updates, alpha=-self.schedule(count))


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   decay_mask: list[bool]) -> NesterovSGD:
    """``decay_mask``: for each parameter, whether it is a convolution kernel
    (``yolo.weight_decay_mask`` gives it for a model)."""
    return NesterovSGD(lr_schedule(cfg, steps_per_epoch), cfg.momentum,
                       cfg.weight_decay, decay_mask)


@dataclasses.dataclass
class TrainState:
    """``params`` and ``batch_stats`` are the model's own tensors, by
    ``state_dict`` key; ``ema_params`` the EMA of the parameters, by key;
    ``trace`` is the optimizer's momentum (flat, in parameter order)."""

    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    trace: torch.Tensor
    ema_params: dict[str, torch.Tensor]
    tx: NesterovSGD

    def apply_gradients(self, grads: Any, new_batch_stats: dict[str, torch.Tensor],
                        ema_decay: float, *, grad_sum=None, sq_norm=None
                        ) -> TrainState:
        """JAX's ``TrainState.apply_gradients``, in place: one optimizer update
        of the parameters from ``grads`` (a list in parameter order, or a
        dict by key), the batch statistics set to ``new_batch_stats`` (a
        train-mode forward has already moved the model's own, which are
        then left as they are), the EMA moved toward the new parameters,
        ``e + (1 - ema_decay) * (p - e)``, and the step counted. Returns the
        state. ``grad_sum`` and ``sq_norm`` serve data-parallel training
        (``NesterovSGD.update``)."""
        params = list(self.params.values())
        if isinstance(grads, dict):
            grads = [grads[k] for k in self.params]
        self.tx.update(params, list(grads), self.trace, self.step,
                       grad_sum=grad_sum, sq_norm=sq_norm)
        with torch.no_grad():
            for k, v in new_batch_stats.items():
                if v is not self.batch_stats[k]:
                    self.batch_stats[k].copy_(v)
            torch._foreach_lerp_(list(self.ema_params.values()), params,
                                 1.0 - ema_decay)
        self.step += 1
        return self

    def eval_state_dict(self, model: YoloSeg) -> dict[str, torch.Tensor]:
        """``model.state_dict()`` with the EMA in place of the parameters: the
        weights evaluation runs with (EMA params, training batch stats)."""
        state = dict(model.state_dict())
        state.update(self.ema_params)
        return state


def _device(device: str | torch.device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA requested but not available; "
                           "pass device='cpu' to run on the CPU")
    return device


def create_train_state(model: YoloSeg, cfg: TrainConfig, steps_per_epoch: int,
                       device: str | torch.device = "cuda") -> TrainState:
    """A state at step 0 for ``model``'s current weights (the JAX
    ``create_train_state`` draws them; here the caller loads or draws them
    first), with the model moved to ``device``. The EMA starts as a copy of
    the parameters, not an alias."""
    model.to(_device(device, "create_train_state"))
    params = dict(model.named_parameters())
    if any(p.dtype != torch.float32 for p in params.values()):
        raise ValueError("train a model with float32 parameters: build it with "
                         "YoloSeg(..., param_dtype=torch.float32)")
    batch_stats = {k: v for k, v in model.named_buffers()
                   if k.endswith(("running_mean", "running_var"))}
    tx = make_optimizer(cfg, steps_per_epoch, weight_decay_mask(model))
    return TrainState(
        step=0, params=params, batch_stats=batch_stats,
        trace=tx.init(list(params.values())),
        ema_params={k: p.detach().clone() for k, p in params.items()}, tx=tx)


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, non_blocking=True)


def make_train_step(model: YoloSeg, loss_cfg: LossConfig, cfg: TrainConfig,
                    collectives=None):
    """Returns the train step ``(state, batch) -> (state, metrics)``: one
    forward and backward of ``model`` in train mode (batch statistics, which
    it moves in place), one optimizer update and one EMA update, all in
    place on ``state``, which must be ``model``'s. ``batch`` is a packed batch
    of numpy arrays or tensors (``data/loader.py``); the metrics are 0-d
    tensors on the model's device (reading them waits for the step).

    With ``collectives`` (``parallel/train_step.py``) it is the data-parallel
    step: ``batch`` is this rank's rows of the global batch, and the step is
    the single-process step on the global batch. ``collectives.sum`` sums the
    loss's normalisers and the metrics over the ranks, ``grad_sum`` and
    ``sq_norm`` serve the optimizer."""
    if cfg.wire_format not in ("bgr", "i420"):
        raise ValueError(f"wire_format must be 'bgr' or 'i420', got {cfg.wire_format!r}")

    def step_fn(state: TrainState, batch: dict[str, Any]):
        params = list(state.params.values())
        if params[0] is not next(model.parameters()):
            raise ValueError("this state's parameters are not the model's")
        dev = params[0].device
        images = _to_device(batch["images"], dev)
        if cfg.wire_format == "i420":
            images = i420_to_bgr(images, cfg.imgsz, cfg.imgsz)
        images = images.float() / 255.0
        if "hsv_gains" in batch:
            # Photometric augmentation on the device: BGR -> RGB, then the
            # per-image HSV gains (1, 1, 1 without augmentation).
            images = hsv_jitter_rgb(images.flip(-1),
                                    _to_device(batch["hsv_gains"], dev))
        targets = {k: _to_device(batch[k], dev)
                   for k in ("boxes", "classes", "valid", "masks")}

        model.train()
        for p in params:
            p.grad = None
        out = model(images.permute(0, 3, 1, 2))
        loss, metrics = yolo_seg_loss(
            out, targets, loss_cfg, cfg.imgsz,
            global_sum=collectives.sum if collectives else None)
        loss.backward()
        # ultralytics EMA ramp: d = decay * (1 - exp(-step / tau)), at the
        # step count before this update.
        decay = cfg.ema_decay * (1.0 - math.exp(-state.step / cfg.ema_ramp))
        state.apply_gradients([p.grad for p in params], state.batch_stats, decay,
                              grad_sum=collectives.grad_sum if collectives else None,
                              sq_norm=collectives.sq_norm if collectives else None)
        if collectives is not None:
            # This rank's shares of the loss and its components, summed.
            keys = ("box", "seg", "cls", "dfl")
            shares = collectives.sum(torch.stack(
                [loss.detach()] + [metrics[k].detach() for k in keys]))
            loss = shares[0]
            metrics.update(zip(keys, shares[1:]))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step_fn
