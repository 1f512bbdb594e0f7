"""Where two float32 train runs part: JAX's and the port's six steps from
trained weights, each held against a float64 run of the port.

    JAX_PLATFORMS=cpu python tests/train_float64_witness.py [SEED ...]

The setting of ``test_torch_train.py``'s six-step test: yolov8n-seg at imgsz
64, batch 2, one batch repeated, from ``v8n_256_study_best.msgpack``. For
each seed (default 1, 2, 3) it prints, for every step, the loss of the
float64 run, and for the JAX and the port float32 runs the loss's relative
distance from it and the largest parameter distance; then, for the SPPF
max-pool windows (2x2 at this size, so a window's maximum is one of four
values), how many windows take their maximum at another pixel in the port's
float32 run than in its float64 run, and the smallest gap between a window's
two largest values in the float64 run. The float64 run casts the model and
the state to float64 and makes ``Tensor.float`` keep float64, since the
model casts its BatchNorm input with it. A few minutes on a CPU.
"""

from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from flax import serialization

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]
import test_torch_train as T  # noqa: E402

from vision_assist_tpu.models import train as jt  # noqa: E402
from vision_assist_tpu.models.checkpoint import load_variables  # noqa: E402
from vision_assist_tpu.models.losses import LossConfig as JaxLossConfig  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu_torch.models import train as tt  # noqa: E402
from vision_assist_tpu_torch.models import yolo as ty  # noqa: E402
from vision_assist_tpu_torch.models.losses import LossConfig  # noqa: E402

STEPS = 6


def jax_run(batch):
    """JAX's parameters after each step, and each step's loss."""
    model = JaxYoloSeg(arch="yolov8n-seg", num_classes=1, dtype=jnp.float32)
    step = jt.make_train_step(model, JaxLossConfig(mask_topk=T.TOPK), T.JCFG)
    restored = load_variables(T.REPO / "assets" / "weights" / T.TRAINED)
    state = jt.create_train_state(model, jax.random.PRNGKey(0), T.JCFG, 10)
    start = {"params": serialization.from_state_dict(state.params, restored["params"]),
             "batch_stats": serialization.from_state_dict(state.batch_stats,
                                                          restored["batch_stats"])}
    state = state.replace(params=start["params"], ema_params=start["params"],
                          batch_stats=start["batch_stats"])
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, losses = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        params.append(jax.tree.map(np.array, {"params": state.params,
                                              "batch_stats": state.batch_stats}))
    return jax.tree.map(np.array, start), params, losses


def port_run(start, batch, dtype):
    """The port's parameters after each step, each step's loss, and the
    inputs and argmax indices of every SPPF max-pool call."""
    pools = []
    max_pool2d, to_float = F.max_pool2d, torch.Tensor.float

    def recording_pool(x, k, stride=None, padding=0, **kw):
        out, idx = max_pool2d(x, k, stride=stride, padding=padding, return_indices=True)
        pools.append((x.detach().double().clone(), idx))
        return out

    F.max_pool2d = recording_pool
    if dtype == torch.float64:
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        model = ty.YoloSeg("yolov8n-seg", dtype=dtype, param_dtype=dtype)
        model.load_state_dict(ty.convert_flax_variables(start, model))
        model.to(dtype)
        params = dict(model.named_parameters())
        state = tt.TrainState(
            step=0, params=params,
            batch_stats={k: v for k, v in model.named_buffers()
                         if k.endswith(("running_mean", "running_var"))},
            trace=torch.zeros(sum(p.numel() for p in params.values()), dtype=dtype),
            ema_params={k: p.detach().clone() for k, p in params.items()},
            tx=tt.make_optimizer(T.TCFG, 10, ty.weight_decay_mask(model)))
        step = tt.make_train_step(model, LossConfig(mask_topk=T.TOPK), T.TCFG)
        out, losses = [], []
        for _ in range(STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            out.append({k: v.detach().double().clone() for k, v in params.items()})
        return out, losses, pools, model
    finally:
        F.max_pool2d, torch.Tensor.float = max_pool2d, to_float


def main(seeds: list[int]) -> int:
    torch.set_num_threads(2)
    for seed in seeds:
        batch = T._batch(seed=seed)
        start, jparams, jlosses = jax_run(batch)
        p32, l32, pools32, model = port_run(start, batch, torch.float32)
        p64, l64, pools64, _ = port_run(start, batch, torch.float64)
        print(f"seed {seed}")
        for i in range(STEPS):
            want = ty.convert_flax_variables(jparams[i], model)
            dj = max(float((want[k].double() - p64[i][k]).abs().max()) for k in p64[i])
            dp = max(float((p32[i][k] - p64[i][k]).abs().max()) for k in p64[i])
            # SPPF pools three times a step; the first sees cv1's output.
            (x32, i32), (x64, i64) = pools32[3 * i], pools64[3 * i]
            top = torch.sort(x64.flatten(2), -1, descending=True).values
            print(f"  step {i + 1}: float64 loss {l64[i]:.6f}; JAX float32 loss "
                  f"{(jlosses[i] - l64[i]) / l64[i]:+.2e}, params {dj:.2e}; port float32 "
                  f"loss {(l32[i] - l64[i]) / l64[i]:+.2e}, params {dp:.2e}; SPPF windows "
                  f"with another argmax {int((i32 != i64).sum())} of {i32.numel()}, "
                  f"smallest top-two gap {float((top[..., 0] - top[..., 1]).min()):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main([int(s) for s in sys.argv[1:]] or [1, 2, 3]))
