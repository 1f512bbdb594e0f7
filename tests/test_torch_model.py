"""Port parity: checkpoint reader, Flax weight bridge and YoloSeg.

The same seeded numpy inputs go through the JAX model (float32) and the
PyTorch port (float32, CPU); every tensor of YoloSegOutputs must agree
within atol 1e-3 plus rtol 1e-3 (float32 convolutions summed in another
order; the largest observed difference is ~1e-5).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu_torch.models.checkpoint import load_variables  # noqa: E402
from vision_assist_tpu_torch.models.yolo import (  # noqa: E402
    YoloSeg,
    convert_flax_variables,
)

torch.set_num_threads(2)

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "assets" / "weights"
CHECKPOINTS = [("yolo11n-seg", "y11n_256_r2_best.msgpack"),
               ("yolov8n-seg", "v8n_640_best.msgpack")]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("asset", [a for _, a in CHECKPOINTS])
def test_msgpack_reader_matches_flax(asset):
    path = WEIGHTS / asset
    mine = load_variables(path)
    ref = serialization.msgpack_restore(path.read_bytes())
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


@pytest.mark.parametrize("arch,asset", CHECKPOINTS)
def test_weight_bridge_consumes_every_leaf_once(arch, asset):
    variables = load_variables(WEIGHTS / asset)
    model = YoloSeg(arch, dtype=torch.float32)
    state = convert_flax_variables(variables, model)
    n_flax = sum(1 for _ in _leaves(variables))
    # Every flax leaf fills one tensor; BN adds num_batches_tracked.
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(state) == n_flax + n_bn
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    model.load_state_dict(state)


def test_weight_bridge_rejects_leftover_leaf():
    variables = load_variables(WEIGHTS / "y11n_256_r2_best.msgpack")
    variables["params"]["Extra_0"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        convert_flax_variables(variables, YoloSeg("yolo11n-seg",
                                                  dtype=torch.float32))


def _compare(jax_out, torch_out):
    for name in ("box_logits", "cls_logits", "coeffs"):
        for a, b in zip(getattr(jax_out, name), getattr(torch_out, name)):
            assert np.isfinite(np.asarray(a)).all()
            np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(a), atol=1e-3, rtol=1e-3,
                                       err_msg=name)
    np.testing.assert_allclose(torch_out.protos.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_out.protos), atol=1e-3, rtol=1e-3)


def _torch_model(arch, variables):
    model = YoloSeg(arch, dtype=torch.float32)
    model.load_state_dict(convert_flax_variables(variables, model))
    return model.eval()


@pytest.mark.parametrize("arch,asset", CHECKPOINTS)
def test_yoloseg_matches_jax(arch, asset):
    variables = load_variables(WEIGHTS / asset)
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    ref = jax.jit(JaxYoloSeg(arch=arch, dtype=jnp.float32).apply)(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = _torch_model(arch, variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.strides == ref.strides
    _compare(ref, out)


def test_yoloseg_legacy_arch_matches_jax():
    """yolo11n-seg-legacy (SiLU on the attention convs, no c3k in the neck)
    with seeded random weights in the Flax tree's shapes."""
    arch = "yolo11n-seg-legacy"
    jm = JaxYoloSeg(arch=arch, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else 1
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = _torch_model(arch, variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    _compare(ref, out)


def test_flagship_record_matches_jax():
    from vision_assist_tpu.models import flagship as jflagship
    from vision_assist_tpu_torch.models import flagship

    assert flagship.flagship() == jflagship.flagship()
    assert flagship.weights_path() == jflagship.weights_path()
    cfg = flagship.model_config()
    ref = jflagship.model_config()
    assert (cfg.arch, cfg.imgsz, cfg.dtype) == (ref.arch, ref.imgsz, ref.dtype)


def test_segmenter_random_init_is_seeded():
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models.inference import Segmenter

    def weights(seed):
        seg = Segmenter(ModelConfig(imgsz=64, dtype="float32"),
                        generator=torch.Generator().manual_seed(seed),
                        example_hw=(64, 64), device="cpu")
        return torch.cat([p.flatten() for p in seg.model.parameters()])

    assert torch.equal(weights(0), weights(0))
    assert not torch.equal(weights(0), weights(1))


# -- the stream dimension -----------------------------------------------------------------


@pytest.mark.parametrize("what", ["model", "frame_chain"])
def test_batched_equals_stack_of_singles(what):
    """Three different frames as one batch against the three on their own,
    float32 on the CPU. The chain after the model is held bit for bit, on the
    model's batched outputs; the model itself (one batch of 3 through the
    convolutions against three batches of 1) within 1e-5 of the largest
    logit, because the convolution library may pick another algorithm for
    another batch size."""
    from test_torch_ops import assert_batched_equals_singles
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models import decode
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.ops.letterbox import (
        letterbox,
        sample_mask_logits_at_points,
    )
    from vision_assist_tpu_torch.utils.streams import stream

    def _heads(o):
        return [*o.box_logits, *o.cls_logits, *o.coeffs, o.protos]

    cfg = ModelConfig(imgsz=64, dtype="float32", conf_threshold=0.3)
    seg = Segmenter(cfg, generator=torch.Generator().manual_seed(3),
                    example_hw=(320, 240), device="cpu")
    frames = np.full((3, 320, 240, 3), 30, np.uint8)
    for i in range(3):
        frames[i, 60 + 30 * i:310, 40 + 25 * i:140 + 25 * i] = 180
    frames = torch.from_numpy(frames)
    with torch.no_grad():
        img = letterbox(frames, dst=cfg.imgsz).permute(0, 3, 1, 2)
        outs = seg.model(img)
        if what == "model":
            for s in range(3):
                single = seg.model(img[s:s + 1])
                for a, b in zip(_heads(outs), _heads(single)):
                    scale = float(b.abs().max())
                    np.testing.assert_allclose(a[s].numpy(), b[0].numpy(),
                                               atol=1e-5 * scale, rtol=0)
            return
        boxes, cls_logits, coeffs = decode.decode_boxes(outs, cfg.reg_max)

    def after_model(boxes, cls_logits, coeffs, protos):
        dets = decode.nms(boxes, cls_logits, coeffs,
                          conf_threshold=cfg.conf_threshold, max_det=cfg.max_detections)
        masks = decode.assemble_masks(protos, dets, (cfg.imgsz, cfg.imgsz))
        return dets, masks, sample_mask_logits_at_points(
            masks, seg._centres, dst=cfg.imgsz)

    assert_batched_equals_singles(after_model,
                                  (boxes, cls_logits, coeffs, outs.protos))
    # The chain as a whole: a stack of 3 gives every field a stream dimension,
    # and stream s is frame s's own result up to the model's tolerance.
    batched = seg._frame_chain(frames)
    assert batched.occupancy.shape == (3, 16, 12) and batched.winner.shape == (3,)
    single = seg._frame_chain(frames[1])
    assert single.occupancy.shape == (16, 12) and single.winner.shape == ()
    assert torch.equal(stream(batched, 1).occupancy, single.occupancy)
