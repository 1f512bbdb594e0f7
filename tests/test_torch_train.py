"""Port parity: training (``models/train.py``), the model's train mode and
``param_dtype`` (``models/yolo.py``), and checkpoints (``models/checkpoint.py``).

yolov8n-seg at imgsz 64, batch 2, float32 on the CPU, started from the JAX
``create_train_state`` through ``convert_flax_variables``; the batch is packed
by the port's loader from the synthetic walkway set. Tolerances are stated in
each test. In train mode BatchNorm normalises by batch statistics, which at
this size come from as few as 8 values a channel; a random-init model's
outputs then differ from JAX by up to ~4e-4 (float32 round-off on both sides:
the port is within ~6e-5 of a float64 run, JAX within ~4e-4), while trained
weights keep both within ~1e-6.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from vision_assist_tpu.models import train as jt  # noqa: E402
from vision_assist_tpu.models.checkpoint import load_variables as jax_load_variables  # noqa: E402
from vision_assist_tpu.models.losses import LossConfig as JaxLossConfig  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu_torch.data.loader import BatchLoader  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet  # noqa: E402
from vision_assist_tpu_torch.models import checkpoint as ck  # noqa: E402
from vision_assist_tpu_torch.models import train as tt  # noqa: E402
from vision_assist_tpu_torch.models import yolo as ty  # noqa: E402
from vision_assist_tpu_torch.models.losses import LossConfig  # noqa: E402
from vision_assist_tpu_torch.ops.yuv import i420_to_bgr  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
S = 64
TOPK = 16
JCFG = jt.TrainConfig(imgsz=S, batch_size=2, lr0=0.01, warmup_epochs=0)
TCFG = tt.TrainConfig(imgsz=S, batch_size=2, lr0=0.01, warmup_epochs=0)
TRAINED = "v8n_256_study_best.msgpack"        # a yolov8n-seg checkpoint


# -- schedule and optimizer ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(epochs=10, warmup_epochs=1, lr0=0.01, lrf=0.1),
                                dict(epochs=3, warmup_epochs=0.5, lr0=0.02, lrf=0.01),
                                dict(epochs=5, warmup_epochs=0)])
def test_lr_schedule_matches_jax(kw):
    jsched = jt.lr_schedule(jt.TrainConfig(**kw), steps_per_epoch=20)
    tsched = tt.lr_schedule(tt.TrainConfig(**kw), steps_per_epoch=20)
    for step in (0, 1, 9, 10, 11, 19, 20, 21, 55, 99, 100, 200):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6,
                                   atol=1e-12)
    if kw["warmup_epochs"]:
        assert tsched(0) == 0.0


def _tree(rng):
    return {"a": {"kernel": rng.normal(0, 1, (3, 4)).astype(np.float32)},
            "b": {"bias": rng.normal(0, 1, (5,)).astype(np.float32)},
            "c": {"kernel": rng.normal(0, 1, (2, 2, 3)).astype(np.float32),
                  "scale": rng.normal(0, 1, (3,)).astype(np.float32)}}


@pytest.mark.parametrize("case", ["nonfinite_above_norm", "below_norm", "warmup"])
def test_optimizer_chain_matches_optax(case):
    """Three steps of the port's chain against the JAX package's optax chain
    on a small tree: parameters and momentum within two float32 ulps (rtol
    2e-6, atol 1e-7).
    The gradients hold NaN and +-Inf entries and a norm above 10, or sit
    below the clip, or the rate warms up from 0."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = dict(epochs=2, warmup_epochs=1 if case == "warmup" else 0)
    tx = jt.make_optimizer(jt.TrainConfig(**cfg), steps_per_epoch=4)
    opt_state = tx.init(jax.tree.map(jnp.asarray, params))
    jparams = jax.tree.map(jnp.asarray, params)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    mask = [path[-1].key == "kernel" for path, _ in leaves]
    tparams = [torch.from_numpy(np.array(v)) for _, v in leaves]
    ttx = tt.make_optimizer(tt.TrainConfig(**cfg), 4, mask)
    trace = ttx.init(tparams)
    for step in range(3):
        scale = 40.0 if case != "below_norm" else 0.1
        grads = jax.tree.map(lambda x: (rng.normal(0, 1, x.shape) * scale).astype(np.float32),
                             params)
        if case == "nonfinite_above_norm":
            grads["a"]["kernel"][0, :3] = [np.nan, np.inf, -np.inf]
            grads["b"]["bias"][1] = np.inf
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.update(tparams, [torch.from_numpy(g) for g in jax.tree.leaves(grads)],
                   trace, step)
        for got, want in zip(tparams, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7)
        want_trace = np.concatenate([np.asarray(t).ravel() for t in
                                     jax.tree.leaves(opt_state[3][0].trace)])
        np.testing.assert_allclose(trace.numpy(), want_trace, rtol=2e-6, atol=1e-7)
        assert all(torch.isfinite(p).all() for p in tparams)


# -- the train step against JAX ---------------------------------------------------------

def _batch(wire: str = "bgr", n: int = 4, seed: int = 1):
    loader = BatchLoader(WalkwaySet(n, 160, 160, seed=seed), batch_size=2, imgsz=S,
                         augment=False, wire_format=wire)
    return loader._pack(np.arange(2))


SEEDS = (1, 2, 3)      # the batches the six-step test runs on


@pytest.fixture(scope="module")
def jax_runs():
    """JAX states after 0 to 6 steps on one batch, with the loss of each
    step: from the random init of create_train_state on the batch of seed 1,
    under ``("init", 1)``, and from a trained checkpoint through the resume
    path (params and EMA take it, and the batch stats) on the batch of each
    seed in SEEDS, under ``("trained", seed)``. A state holds the optimizer's
    momentum trace beside the parameters."""
    model = JaxYoloSeg(arch="yolov8n-seg", num_classes=1, dtype=jnp.float32)
    step = jt.make_train_step(model, JaxLossConfig(mask_topk=TOPK), JCFG)
    restored = jax_load_variables(REPO / "assets" / "weights" / TRAINED)
    created = jt.create_train_state(model, jax.random.PRNGKey(0), JCFG, 10)
    runs = {}
    for start, seed in [("init", 1)] + [("trained", s) for s in SEEDS]:
        batch = {k: jnp.asarray(v) for k, v in _batch(seed=seed).items()}
        state = jax.tree.map(jnp.copy, created)      # the step donates its state
        if start == "trained":
            state = state.replace(
                params=serialization.from_state_dict(state.params, restored["params"]),
                ema_params=serialization.from_state_dict(state.ema_params,
                                                         restored["params"]),
                batch_stats=serialization.from_state_dict(state.batch_stats,
                                                          restored["batch_stats"]))
        snaps, losses = [], []
        for i in range(7):
            snaps.append(jax.tree.map(np.array, {
                "params": state.params, "batch_stats": state.batch_stats,
                "ema": state.ema_params, "trace": state.opt_state[3][0].trace,
                "step": state.step}))
            if i < 6:
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
        runs[start, seed] = (snaps, losses)
    return runs


def _port_state(snap):
    """The port's model and train state at a JAX state: parameters, batch
    statistics, EMA, momentum trace and step count."""
    model = ty.YoloSeg("yolov8n-seg", dtype=torch.float32, param_dtype=torch.float32)
    model.load_state_dict(ty.convert_flax_variables(
        {"params": snap["params"], "batch_stats": snap["batch_stats"]}, model))
    state = tt.create_train_state(model, TCFG, 10, device="cpu")
    state.trace.copy_(_flat_trace(snap, model, state))
    state.step = int(snap["step"])
    with torch.no_grad():
        for k, v in ty.convert_flax_variables(
                {"params": snap["ema"], "batch_stats": snap["batch_stats"]}, model).items():
            if k in state.ema_params:
                state.ema_params[k].copy_(v)
    return model, state


def _flat_trace(snap, model, state):
    """JAX's momentum trace as the port keeps it: one flat vector, in the
    order of the model's parameters."""
    tree = ty.convert_flax_variables({"params": snap["trace"],
                                      "batch_stats": snap["batch_stats"]}, model)
    return torch.cat([tree[k].reshape(-1) for k in state.params])


def _assert_state_close(model, state, snap, atol_p, atol_bs, rtol_bs):
    want = ty.convert_flax_variables({"params": snap["params"],
                                      "batch_stats": snap["batch_stats"]}, model)
    want_ema = ty.convert_flax_variables({"params": snap["ema"],
                                          "batch_stats": snap["batch_stats"]}, model)
    assert state.step == int(snap["step"])
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=0,
                                   atol=atol_p, err_msg=k)
        np.testing.assert_allclose(state.ema_params[k].numpy(), want_ema[k].numpy(),
                                   rtol=0, atol=atol_p, err_msg=k)
    for k, v in state.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=rtol_bs,
                                   atol=atol_bs, err_msg=k)


@pytest.mark.parametrize("start,atol_p,atol_bs,rtol_loss", [
    ("init", 1e-4, 1e-4, 5e-4),      # seen: 2.0e-5, 1.7e-5, 7e-5
    ("trained", 1e-5, 1e-5, 1e-5),   # seen: 5.2e-7, 9.5e-7, 5e-6
])
def test_one_train_step_matches_jax(jax_runs, start, atol_p, atol_bs, rtol_loss):
    """Loss, parameters, batch statistics (moved by the biased batch
    variance: the unbiased one would be off by n/(n-1), 14 % at 8 values),
    EMA and step after one step, within the stated absolute tolerances."""
    snaps, losses = jax_runs[start, 1]
    model, state = _port_state(snaps[0])
    step = tt.make_train_step(model, LossConfig(mask_topk=TOPK), TCFG)
    state, metrics = step(state, _batch())
    np.testing.assert_allclose(float(metrics["loss"]), losses[0], rtol=rtol_loss)
    _assert_state_close(model, state, snaps[1], atol_p, atol_bs, 1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_six_train_steps_match_jax_and_lower_the_loss(jax_runs, seed):
    """Each of six steps from the trained start, begun from JAX's state before
    it (parameters, batch statistics, EMA, momentum trace, step count), gives
    JAX's state after it: the loss within rtol 1e-5, parameters and EMA within
    atol 1e-5, batch statistics within atol and rtol 1e-5, the trace within
    atol 5e-4, since a step moves a parameter by lr0 = 0.01 times about twice
    the trace (seen on the three batches: 2.7e-6, 1.3e-6, under 1e-7 past the
    rtol, 6.8e-5).
    So by induction the port's run is JAX's up to float32 round-off. The
    port's own run of six steps then lowers its loss, from the trained start
    and from the random init.

    Two free runs of six float32 steps are not compared: they part wherever
    a discrete choice is near a tie, and which of the two leaves the exact
    run depends on the batch. Against a float64 run of the port
    (tests/train_float64_witness.py prints these readings), on the batch
    of seed 2 the port's float32 run leaves at the third step (one SPPF
    max-pool window at 2x2, top two values 3.4e-5 apart, routes its gradient
    to the other pixel; the loss is 4e-3 off at the fourth step); on seed 1 it
    is JAX's float32 run that leaves, at the fifth step (parameters 1.5e-3
    off, the loss 6.5e-2 at the sixth), while the port's stays within 6e-5;
    on seed 3 neither leaves."""
    snaps, losses = jax_runs["trained", seed]
    batch = _batch(seed=seed)
    for i in range(6):
        model, state = _port_state(snaps[i])
        step = tt.make_train_step(model, LossConfig(mask_topk=TOPK), TCFG)
        state, metrics = step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), losses[i], rtol=1e-5,
                                   err_msg=f"step {i}")
        _assert_state_close(model, state, snaps[i + 1], 1e-5, 1e-5, 1e-5)
        np.testing.assert_allclose(state.trace.numpy(),
                                   _flat_trace(snaps[i + 1], model, state).numpy(),
                                   rtol=0, atol=5e-4, err_msg=f"step {i}")

    for start in ("trained", "init"):
        model, state = _port_state(jax_runs[start, 1 if start == "init" else seed][0][0])
        step = tt.make_train_step(model, LossConfig(mask_topk=TOPK), TCFG)
        got = [float(step(state, batch)[1]["loss"]) for _ in range(6)]
        assert all(np.isfinite(got)) and got[-1] < got[0] and state.step == 6, (start, got)


def test_i420_step_equals_bgr_step_on_the_unpacked_images(jax_runs):
    """The i420 wire converts on the device; one step on it equals, bit for
    bit, a bgr step fed the images that conversion gives."""
    i420 = _batch("i420")
    bgr = dict(i420, images=i420_to_bgr(torch.from_numpy(i420["images"]), S, S).numpy())
    results = []
    for wire, batch in (("i420", i420), ("bgr", bgr)):
        model, state = _port_state(jax_runs["trained", 1][0][0])
        step = tt.make_train_step(model, LossConfig(mask_topk=TOPK),
                                  dataclasses.replace(TCFG, wire_format=wire))
        state, metrics = step(state, batch)
        results.append((float(metrics["loss"]), state))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1].params.values(), results[1][1].params.values()):
        assert torch.equal(a, b)
    # The two wires carry nearly the same pixels (chroma is subsampled, and
    # the walkway frames carry per-pixel noise of +-25).
    packed = _batch("bgr")["images"].astype(int)
    assert np.abs(bgr["images"].astype(int) - packed).mean() < 10.0


# -- checkpoints ----------------------------------------------------------------------

def test_train_state_save_and_resume_is_exact(jax_runs, tmp_path):
    model, state = _port_state(jax_runs["trained", 1][0][0])
    step = tt.make_train_step(model, LossConfig(mask_topk=TOPK), TCFG)
    batch = _batch()
    for _ in range(2):
        state, _ = step(state, batch)
    ck.save_train_state(tmp_path / "state.pt", state)

    other, fresh = _port_state(jax_runs["init", 1][0][0])
    fresh = ck.load_train_state(tmp_path / "state.pt", fresh)
    assert fresh.step == 2
    state, m1 = step(state, batch)
    fresh, m2 = tt.make_train_step(other, LossConfig(mask_topk=TOPK), TCFG)(fresh, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for name in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(state, name).items():
            assert torch.equal(v, getattr(fresh, name)[k]), (name, k)
    assert torch.equal(state.trace, fresh.trace) and state.step == fresh.step == 3


def test_msgpack_written_by_the_port_is_read_by_jax(jax_runs, tmp_path):
    """save_variables writes Flax's own bytes; JAX's load_variables and the
    port's reader give the tree back, and the JAX model on it gives the
    port's eval-mode outputs (within 1e-4)."""
    model, state = _port_state(jax_runs["trained", 1][0][0])
    step = tt.make_train_step(model, LossConfig(mask_topk=TOPK), TCFG)
    state, _ = step(state, _batch())
    tree = ty.to_flax_variables(model)
    ck.save_variables(tmp_path / "w.msgpack", tree)
    raw = (tmp_path / "w.msgpack").read_bytes()
    assert raw == serialization.msgpack_serialize(tree)
    for restored in (jax_load_variables(tmp_path / "w.msgpack"),
                     ck.load_variables(tmp_path / "w.msgpack")):
        flat = dict(jax.tree_util.tree_flatten_with_path(restored)[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            np.testing.assert_array_equal(flat[path], leaf)
    # The round trip through the bridge is exact.
    back = ty.convert_flax_variables(ck.load_variables(tmp_path / "w.msgpack"), model)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k

    x = np.random.default_rng(0).random((1, S, S, 3), np.float32)
    jout = JaxYoloSeg(arch="yolov8n-seg", dtype=jnp.float32).apply(
        jax_load_variables(tmp_path / "w.msgpack"), jnp.asarray(x))
    with torch.no_grad():
        tout = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b in zip(jout.box_logits, tout.box_logits):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), np.asarray(a), atol=1e-4)


# -- the model: train mode and param_dtype -------------------------------------------------

def _old_convbnact_forward(self, x):
    """ConvBNAct.forward before param_dtype existed."""
    y = self.conv(ty._pad_same(x, self.kernel, self.stride))
    y = self.bn(y.float())
    return (torch.nn.functional.silu(y) if self.act else y).to(self.dtype)


def _old_proto_forward(self, x):
    return self.cv3(self.cv2(self.up(self.cv1(x))))


@pytest.mark.parametrize("arch", ["yolo11n-seg", "yolov8n-seg"])
def test_serving_model_is_unchanged_by_param_dtype(arch, monkeypatch):
    """With the default param_dtype (the compute dtype), bf16 serving is bit
    for bit what it was, and its state_dict keys and dtypes are as before:
    the convolutions' weights in the compute dtype, the head's 1x1
    convolutions and BatchNorm in float32."""
    torch.manual_seed(0)
    model = ty.YoloSeg(arch).eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.uniform_(0.5, 2.0)
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        new = model(x)
        monkeypatch.setattr(ty.ConvBNAct, "forward", _old_convbnact_forward)
        monkeypatch.setattr(ty.Proto, "forward", _old_proto_forward)
        old = model(x)
    for a, b in zip(jax.tree.leaves([new.box_logits, new.cls_logits, new.coeffs,
                                     new.protos]),
                    jax.tree.leaves([old.box_logits, old.cls_logits, old.coeffs,
                                     old.protos])):
        assert torch.equal(a, b)
    head_convs = {n for n, m in model.named_modules()          # the 1x1s with a bias
                  if isinstance(m, torch.nn.Conv2d) and m.bias is not None}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.int64
        elif ".bn." in k or k.rsplit(".", 1)[0] in head_convs:
            assert v.dtype == torch.float32, k
        else:
            assert v.dtype == torch.bfloat16, k
    assert set(model.state_dict()) == set(
        ty.YoloSeg(arch, param_dtype=torch.float32).state_dict())


def test_float32_params_compute_in_bf16():
    """param_dtype=float32 keeps the weights float32 and casts them for the
    convolution: the same outputs, bit for bit, as a bf16 model holding the
    weights rounded to bf16."""
    torch.manual_seed(1)
    f32 = ty.YoloSeg("yolo11n-seg", param_dtype=torch.float32).eval()
    bf16 = ty.YoloSeg("yolo11n-seg").eval()
    bf16.load_state_dict(f32.state_dict())
    convs = [m for m in f32.modules() if isinstance(m, (torch.nn.Conv2d,
                                                        torch.nn.ConvTranspose2d))]
    assert all(m.weight.dtype == torch.float32 for m in convs)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert torch.equal(a.protos, b.protos)
    for u, v in zip(a.box_logits, b.box_logits):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="float32 parameters"):
        tt.create_train_state(bf16, TCFG, 10, device="cpu")


def test_train_mode_batch_norm_moves_running_stats_the_flax_way():
    """One ConvBNAct in train mode: the output is normalised by the batch's
    biased variance, and the running statistics move to 0.97 * old + 0.03 *
    batch (biased variance; nn.BatchNorm2d would use the unbiased one)."""
    torch.manual_seed(2)
    block = ty.ConvBNAct(3, 4, 3, dtype=torch.float32).train()
    with torch.no_grad():
        block.bn.running_mean.uniform_(-1, 1)
        block.bn.running_var.uniform_(0.5, 2)
    mean0, var0 = block.bn.running_mean.clone(), block.bn.running_var.clone()
    x = torch.rand(2, 3, 4, 4)
    out = block(x)
    y = block.conv(ty._pad_same(x, 3, 1))
    mean, var = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(block.bn.running_mean, 0.97 * mean0 + 0.03 * mean,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(block.bn.running_var, 0.97 * var0 + 0.03 * var,
                               rtol=1e-6, atol=1e-7)
    norm = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-3)
    want = torch.nn.functional.silu(norm * block.bn.weight[:, None, None]
                                    + block.bn.bias[:, None, None])
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


# -- the port's boundaries ------------------------------------------------------------------

def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from vision_assist_tpu_torch.models.evaluate import evaluate, evaluate_dataset

    model = ty.YoloSeg("yolov8n-seg", dtype=torch.float32, param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.create_train_state(model, TCFG, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_dataset(model, WalkwaySet(2, 32, 32), imgsz=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(model, ty.to_flax_variables(model), REPO, imgsz=32)


FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|cv2|msgpack|PIL|"
                       r"imageio|scipy|vision_assist_tpu)(?:\.|\s|$)", re.M)


def test_no_forbidden_imports_anywhere_in_the_port():
    files = sorted((REPO / "vision_assist_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    names = {f.relative_to(REPO).as_posix() for f in files}
    # The command line, bench, export, goldens and their modules are scanned.
    assert {f"vision_assist_tpu_torch/{m}.py" for m in (
        "main", "bench", "export_model", "generate_goldens", "io/scenarios",
        "io/mock_camera", "io/speech", "io/tts", "utils/profiling",
        "golden/peaks", "golden/pipeline")} <= names
    for f in files:
        found = FORBIDDEN.findall(f.read_text())
        assert not found, f"{f.relative_to(REPO)} imports {found}"


@pytest.mark.parametrize("line", ["from scipy.signal import lfilter", "import scipy",
                                  "    import jax.numpy as jnp",
                                  "from vision_assist_tpu.io import tts"])
def test_the_import_scan_catches(line):
    assert FORBIDDEN.findall(f"x = 1\n{line}\n")
