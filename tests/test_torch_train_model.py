"""The training driver (``python -m vision_assist_tpu_torch.train_model``) on
the CPU, and ``models/flagship.py::write_flagship``, against the JAX package.

yolov8n-seg at imgsz 64, batch 2, from ``v8n_256_study_best.msgpack``
(``--resume``), on 8 training and 4 validation walkway frames written as a
PNG dataset directory: 2 epochs with close-mosaic 1, an evaluation and a
saved state every epoch, then a third epoch resumed from the saved state.
The history's keys are the JAX driver's, taken from the JAX train step's
metrics and the JAX ``MapAccumulator``; the checkpoints are read by the JAX
``load_variables``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.models import train as jt  # noqa: E402
from vision_assist_tpu.models.checkpoint import load_variables as jax_load_variables  # noqa: E402
from vision_assist_tpu.models.losses import LossConfig as JaxLossConfig  # noqa: E402
from vision_assist_tpu.models.metrics import MapAccumulator as JaxMapAccumulator  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu_torch import train_model  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet, write_split  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAINED = REPO / "assets" / "weights" / "v8n_256_study_best.msgpack"


def _run(argv: list[str]) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_model.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory) -> pathlib.Path:
    root = tmp_path_factory.mktemp("walkways")
    write_split(WalkwaySet(8, 96, 128, seed=1), root, "train")
    write_split(WalkwaySet(4, 96, 128, seed=2), root, "valid")
    return root


def _argv(data: pathlib.Path, out: pathlib.Path, epochs: int, *extra: str) -> list[str]:
    return ["--data", str(data), "--arch", "yolov8n-seg", "--imgsz", "64",
            "--batch", "2", "--epochs", str(epochs), "--close-mosaic", "1",
            "--eval-every", "1", "--save-state-every", "1", "--workers", "2",
            "--out", str(out), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """(stdout of the 2-epoch run, stdout of the resumed third epoch, out dir)."""
    out = tmp_path_factory.mktemp("run")
    rc1, log1 = _run(_argv(data, out, 2, "--resume", str(TRAINED)))
    history2 = json.loads((out / "history.json").read_text())
    rc2, log2 = _run(_argv(data, out, 3, "--resume-state", str(out / "state")))
    assert rc1 == rc2 == 0, log1 + log2
    return log1, log2, out, history2


def _jax_history_keys() -> set[str]:
    """The keys the JAX driver writes into a record with an evaluation: the
    epoch, the JAX train step's metrics, time_s and the mAP dict."""
    cfg = jt.TrainConfig(imgsz=64, batch_size=2)
    model = JaxYoloSeg(arch="yolov8n-seg", num_classes=1, dtype=jnp.float32)
    state = jax.eval_shape(lambda: jt.create_train_state(
        model, jax.random.PRNGKey(0), cfg, 4))
    batch = {"images": jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.uint8),
             "masks": jax.ShapeDtypeStruct((2, 16, 16), jnp.uint8),
             "boxes": jax.ShapeDtypeStruct((2, 32, 4), jnp.float32),
             "classes": jax.ShapeDtypeStruct((2, 32), jnp.int32),
             "valid": jax.ShapeDtypeStruct((2, 32), jnp.bool_),
             "hsv_gains": jax.ShapeDtypeStruct((2, 3), jnp.float32)}
    _, metrics = jax.eval_shape(jt.make_train_step(model, JaxLossConfig(), cfg),
                                state, batch)
    return {"epoch", "time_s", *metrics, *JaxMapAccumulator().result()}


def test_history_has_the_jax_drivers_keys(runs):
    _, _, out, _ = runs
    history = json.loads((out / "history.json").read_text())
    assert [h["epoch"] for h in history] == [1, 2, 3]
    want = _jax_history_keys()
    for h in history:
        assert set(h) == want
        assert all(math.isfinite(h[k]) for k in want)
    assert not (out / "history.json.tmp").exists()


def test_checkpoints_are_read_by_jax(runs):
    _, _, out, _ = runs
    ref = jax_load_variables(TRAINED)
    for name in ("best.msgpack", "last.msgpack"):
        got = jax_load_variables(out / name)
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == np.float32
        assert not all(np.array_equal(a, b) for a, b in
                       zip(jax.tree.leaves(got["params"]), jax.tree.leaves(ref["params"])))


def test_close_mosaic_and_resume_land_on_the_right_epoch(runs):
    log1, log2, out, history2 = runs
    lines = log1.splitlines()
    # Mosaic closes before the last epoch (epochs 2, close-mosaic 1).
    closed = lines.index("mosaic closed")
    assert lines[closed - 1].startswith("  host rss") and lines[closed + 1].startswith("epoch 2/2")
    assert "resumed params from" in log1 and len(history2) == 2
    assert "resumed full train state" in log2 and "(step 8)" in log2
    assert "continuing at epoch 3" in log2
    # A fresh loader inside the closed window closes mosaic again (<=).
    assert "mosaic closed" in log2 and "epoch 3/3" in log2
    assert {p.name for p in out.iterdir()} >= {"args.json", "history.json", "best.msgpack",
                                                "last.msgpack", "state", "state_prev"}
    assert not (out / "state_new").exists()
    args = json.loads((out / "args.json").read_text())
    assert args["resume_state"] == str(out / "state") and args["device"] == "cpu"
    assert set(args) == set(vars(train_model._parser().parse_args(["--data", "x"])))


def test_collapse_guard_reverts_to_the_saved_state(runs, data, tmp_path):
    """The 2-epoch run's output with two healthy records of ten times the
    foreground put before its own: resumed from the state after epoch 2, the
    third epoch is the first the guard judges, its foreground is below half
    the median, so the driver reverts to the saved state and writes neither
    a state nor last.msgpack."""
    _, _, out, history2 = runs
    work = tmp_path / "run"
    shutil.copytree(out, work)
    fake = [{**history2[0], "epoch": 0, "fg_per_img": 10 * h["fg_per_img"]} for h in history2]
    (work / "history.json").write_text(json.dumps(fake + history2))
    before = {n: (work / n).read_bytes() for n in ("state", "last.msgpack")}
    rc, log = _run(_argv(data, work, 3, "--resume-state", str(work / "state_prev")))
    assert rc == 0 and "continuing at epoch 3" in log and "COLLAPSE at epoch 3" in log
    history = json.loads((work / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 0, 1, 2, 3] and history[-1]["reverted"]
    assert {n: (work / n).read_bytes() for n in before} == before


def _rec(loss, fg, reverted=False):
    return {"loss": loss, "fg_per_img": fg, **({"reverted": True} if reverted else {})}


@pytest.mark.parametrize("case", ["healthy", "loss_spike", "fg_collapse", "nan",
                                  "too_few", "no_state", "reverted_skipped"])
def test_collapse_decision(case):
    base = [_rec(10.0, 4.0), _rec(11.0, 4.2), _rec(9.0, 3.8), _rec(10.5, 4.1)]
    history, mean, avail, want = base, _rec(12.0, 3.9), True, False
    if case == "loss_spike":
        mean, want = _rec(10.25 * 1.6 + 0.1, 4.0), True
    elif case == "fg_collapse":
        mean, want = _rec(10.0, 0.49 * 4.05), True
    elif case == "nan":
        mean, want = _rec(float("nan"), 4.0), True
    elif case == "too_few":
        history, mean = base[:3], _rec(float("nan"), 0.0)
    elif case == "no_state":
        mean, avail = _rec(float("nan"), 0.0), False
    elif case == "reverted_skipped":
        # A reverted epoch is no evidence of health: 3 healthy of 4 is too few.
        history, mean = base[:3] + [_rec(99.0, 0.0, reverted=True)], _rec(float("nan"), 0.0)
    collapsed, med_loss, med_fg = train_model.collapse_decision(history, mean, avail)
    assert collapsed is want
    if case in ("too_few", "no_state", "reverted_skipped"):
        assert math.isnan(med_loss) and math.isnan(med_fg)
    else:
        assert med_loss == 10.25 and med_fg == pytest.approx(4.05)


def test_driver_boundaries(data, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="zero steps"):
        _run(_argv(data, tmp_path, 1)[:-2] + ["--device", "cpu", "--batch", "16"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_model.main(["--data", str(data), "--out", str(tmp_path)])
    # With VAT_COORDINATOR, a one-process gloo group (the rendezvous a file)
    # trains the epoch a single-process run trains, the history equal but
    # for the times.
    _, plain = _run(_argv(data, tmp_path / "plain", 1, "--resume", str(TRAINED)))
    monkeypatch.setenv("VAT_COORDINATOR", f"file://{tmp_path / 'rendezvous'}")
    monkeypatch.setenv("VAT_NUM_PROCESSES", "1")
    monkeypatch.setenv("VAT_PROCESS_ID", "0")
    try:
        rc, multi = _run(_argv(data, tmp_path / "multi", 1, "--resume", str(TRAINED)))
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert rc == 0, multi
    histories = [json.loads((tmp_path / d / "history.json").read_text())
                 for d in ("plain", "multi")]
    for h in histories:
        for rec in h:
            rec.pop("time_s")
    assert histories[0] == histories[1]
    assert (tmp_path / "multi" / "last.msgpack").read_bytes() == \
        (tmp_path / "plain" / "last.msgpack").read_bytes()


def test_write_flagship_matches_jax(tmp_path, monkeypatch):
    from vision_assist_tpu.models import flagship as jflag
    from vision_assist_tpu_torch.models import flagship as tflag

    real = REPO / "assets" / "weights" / "FLAGSHIP.json"
    before = real.read_bytes()
    monkeypatch.setattr(jflag, "FLAGSHIP_PATH", tmp_path / "jax.json")
    kw = dict(map50_mask=0.8, train_split="train", epochs=3)
    want = jflag.write_flagship("a.msgpack", "yolo11n-seg", 256, **kw)
    got = tflag.write_flagship("a.msgpack", "yolo11n-seg", 256, path=tmp_path / "port.json", **kw)
    for rec in (want, got):
        rec.pop("switched_at")
    assert got == want
    on_disk = [json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json")]
    assert list(on_disk[0]) == list(on_disk[1])
    assert on_disk[1]["asset"] == "a.msgpack" and not (tmp_path / "port.json.tmp").exists()
    assert real.read_bytes() == before
