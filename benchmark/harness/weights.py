"""The weights a configuration is served with: one Flax-layout tree of numpy
arrays ({"params", "batch_stats"}) that the port and the plain reference
both load. A configuration gives either a trained file
(``"weights": "<path under the checkout>"``) or a seed
(``"weights": {"seed": <int>}``), for an architecture with no trained
weights in the repository. The draw knows convolutions, Linear layers,
BatchNorms and LayerNorms, so it serves a model of either head kind: an
instance head's (YOLO-seg) and a per-pixel head's (a transformer encoder
with an MLP decoder)."""

from __future__ import annotations

import math

import numpy as np

NORMAL_SD = 0.2             # of a bias, and of a running mean in its channel's SDs
SCALE = (0.05, 0.15)        # the range of a BatchNorm's scale
CALIBRATION_FRAMES = 8      # fewer leave the deepest, smallest levels' statistics noisy


def seeded(config: dict) -> bool:
    return isinstance(config["weights"], dict)


def flax_tree(root, config: dict, device) -> dict:
    """The configuration's weights, from its file or drawn from its seed on
    ``device``."""
    if not seeded(config):
        from benchmark.reference.msgpack import load_variables

        return load_variables(root / config["weights"])
    from benchmark.harness.cell import reference_module

    return draw(reference_module(root, config), config, int(config["weights"]["seed"]),
                device)


def _flax_shape(shape: tuple, layout: str) -> tuple:
    if layout == "conv":                  # OIHW -> HWIO
        return (shape[2], shape[3], shape[1], shape[0])
    if layout == "conv_transpose":        # (in, out, kh, kw) -> (kh, kw, in, out)
        return (shape[2], shape[3], shape[0], shape[1])
    if layout == "dense":                 # (out, in) -> (in, out)
        return (shape[1], shape[0])
    return shape


def draw(arch, config: dict, seed: int, device) -> dict:
    """Weights for the reference module ``arch``'s model of ``config``, drawn
    from ``seed``: each leaf of ``arch.flax_leaves`` in creation order takes
    the next numbers of one of two streams, made on ``device`` by a
    ``torch.Generator`` seeded with ``seed`` in two calls (the same seed
    gives the same tree on one kind of device). A leaf's layout says how
    its tensor lies in Flax: "conv" (HWIO), "conv_transpose" (kh, kw, in,
    out), "dense" (a Linear's kernel, (in, out) in Flax and (out, in) in
    torch), "layer_norm" (a LayerNorm's scale), "same" (one array).

    * a kernel ("kernel"): N(0, 1 / fan_in), fan_in the taps a
      convolution's output sums (kh * kw * input channels of its group; a
      transposed convolution's input channels, its kernel being its stride;
      a Linear's input features);
    * a bias ("bias"): N(0, NORMAL_SD**2);
    * a BatchNorm's scale ("scale"): U(*SCALE);
    * a BatchNorm's running statistics ("mean", "var"): its channel's mean
      plus N(0, NORMAL_SD**2) of its channel's SDs, and its channel's
      variance times U(0.5, 1.5), the channel's mean and variance taken on
      ``CALIBRATION_FRAMES`` walkway frames of the model's input size drawn
      from ``seed``, through the model with every BatchNorm before it so set;
    * any other leaf, a LayerNorm's scale ("scale", layout "layer_norm")
      among them: U(0.5, 1.5). At a BatchNorm's small scale each residual
      branch of a pre-norm transformer would shrink to about a tenth, and
      the model would come close to the identity.

    So every BatchNorm is far from the identity and its whole arithmetic
    shows in the output, and yet each scales its channels to a set size, as
    in a trained model: activations neither vanish nor blow up through any
    depth, residual sums and concatenations included. The small scale keeps
    each SiLU near its linear range about its bias: at a scale about 1 a
    random network amplifies a perturbation of its input some hundredfold
    over yolo11n-seg's depth, and the served precision's rounding with it.
    """
    import torch

    with torch.device("meta"):
        model = arch.build_model(config)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    leaves = [(key, path, layout, _flax_shape(shapes[key], layout))
              for key, path, layout in arch.flax_leaves(model)]

    def normal(path):
        return path[-1] in ("kernel", "bias", "mean")

    sizes = [sum(math.prod(s) for _, p, _, s in leaves if normal(p) == want)
             for want in (True, False)]
    gen = torch.Generator(device).manual_seed(seed)
    z = torch.randn(sizes[0], generator=gen, device=device).cpu().numpy()
    u = torch.rand(sizes[1], generator=gen, device=device).cpu().numpy()
    tree: dict = {}
    iz = iu = 0
    for _, path, layout, shape in leaves:
        n = math.prod(shape)
        if normal(path):
            sd = NORMAL_SD
            if path[-1] == "kernel":
                fan_in = shape[2] if layout == "conv_transpose" else math.prod(shape[:-1])
                sd = 1.0 / math.sqrt(fan_in)
            value, iz = z[iz:iz + n] * sd, iz + n
        else:
            lo, hi = SCALE if path[-1] == "scale" and layout != "layer_norm" else (0.5, 1.5)
            value, iu = lo + (hi - lo) * u[iu:iu + n], iu + n
        _put(tree, path, value.reshape(shape).astype(np.float32))
    model = model.to_empty(device=device).eval()
    arch.load_flax_variables(model, tree)
    _calibrate(model, config["imgsz"], seed, device)
    state = model.state_dict()
    for key, path, _, _ in leaves:
        if path[-1] in ("mean", "var"):
            _put(tree, path, state[key].float().cpu().numpy())
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _calibrate(model, imgsz: int, seed: int, device) -> None:
    """Turn each BatchNorm's drawn running statistics (a mean in SDs, a
    factor of the variance) into its channels' own, in one forward pass in
    which every BatchNorm is set just before it runs, TF32 off whatever the
    process's flags (as the reference computes)."""
    import torch
    from torch import nn

    from benchmark.harness.frames import walkway_pool
    from benchmark.reference.segment import ExactFloat32

    def set_statistics(bn, inputs):
        x = inputs[0].float()
        var = x.var(dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)) + bn.running_mean * var.sqrt())
        bn.running_var.copy_(var * bn.running_var)

    hooks = [m.register_forward_pre_hook(set_statistics)
             for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    frames = walkway_pool(CALIBRATION_FRAMES, imgsz, imgsz, seed)
    images = torch.from_numpy(frames[..., ::-1].copy()).to(device)
    try:
        with torch.no_grad(), ExactFloat32():
            model(images.permute(0, 3, 1, 2).float() / 255.0)
    finally:
        for h in hooks:
            h.remove()
