"""The port's entry points take the JAX package's parameters in the JAX
order, with the same defaults, so a call written for one package means the
same in the other; the port may only add parameters at the end (such as
``device``). ``FrameResult`` and ``AugmentConfig`` have the JAX fields in
the JAX order. The command lines (``main.build_parser``, ``export_model``)
have the JAX flags in the JAX order with the JAX defaults.

The recorded departures, each held by a test below:

* ``--device`` (default ``cuda``) is the one flag the command lines add;
* ``MockCamera`` reads an .npy frame stack or a PNG directory, not an
  encoded video (no decoder), and its source rate is the target rate;
* ``generate_goldens`` requires ``--out`` (the JAX script writes into
  tests/fixtures/goldens/);
* ``main image`` reads PNG only (no JPEG decoder).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import inspect
import pathlib

import pytest

jax = pytest.importorskip("jax")

from vision_assist_tpu import main as jmain  # noqa: E402
from vision_assist_tpu.data import augment as jaug  # noqa: E402
from vision_assist_tpu.data import dataset as jds  # noqa: E402
from vision_assist_tpu.data import loader as jloader  # noqa: E402
from vision_assist_tpu.golden import pipeline as jgolden  # noqa: E402
from vision_assist_tpu.io import mock_camera as jcam  # noqa: E402
from vision_assist_tpu.io import speech as jspeech  # noqa: E402
from vision_assist_tpu.io import tts as jtts  # noqa: E402
from vision_assist_tpu.models import evaluate as jeval  # noqa: E402
from vision_assist_tpu.pipeline import frame_processor as jfp  # noqa: E402
from vision_assist_tpu.pipeline import multi_stream as jms  # noqa: E402
from vision_assist_tpu.pipeline import server as jserver  # noqa: E402
from vision_assist_tpu.utils import profiling as jprof  # noqa: E402
from vision_assist_tpu_torch import export_model, generate_goldens  # noqa: E402
from vision_assist_tpu_torch import main as tmain  # noqa: E402
from vision_assist_tpu_torch.data import augment as taug  # noqa: E402
from vision_assist_tpu_torch.data import dataset as tds  # noqa: E402
from vision_assist_tpu_torch.data import loader as tloader  # noqa: E402
from vision_assist_tpu_torch.golden import pipeline as tgolden  # noqa: E402
from vision_assist_tpu_torch.io import mock_camera as tcam  # noqa: E402
from vision_assist_tpu_torch.io import speech as tspeech  # noqa: E402
from vision_assist_tpu_torch.io import tts as ttts  # noqa: E402
from vision_assist_tpu_torch.models import evaluate as teval  # noqa: E402
from vision_assist_tpu_torch.pipeline import frame_processor as tfp  # noqa: E402
from vision_assist_tpu_torch.pipeline import multi_stream as tms  # noqa: E402
from vision_assist_tpu_torch.pipeline import server as tserver  # noqa: E402
from vision_assist_tpu_torch.utils import profiling as tprof  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

PAIRS = {
    "FrameProcessor.__init__": (jfp.FrameProcessor.__init__, tfp.FrameProcessor.__init__),
    "FrameProcessor.process_occupancy": (jfp.FrameProcessor.process_occupancy,
                                         tfp.FrameProcessor.process_occupancy),
    "FrameProcessor.retire_frame": (jfp.FrameProcessor.retire_frame,
                                    tfp.FrameProcessor.retire_frame),
    "FrameProcessor.submit_frame": (jfp.FrameProcessor.submit_frame,
                                    tfp.FrameProcessor.submit_frame),
    "FrameProcessor.__call__": (jfp.FrameProcessor.__call__, tfp.FrameProcessor.__call__),
    "MultiStreamProcessor.__init__": (jms.MultiStreamProcessor.__init__,
                                      tms.MultiStreamProcessor.__init__),
    "StreamingServer.__init__": (jserver.StreamingServer.__init__,
                                 tserver.StreamingServer.__init__),
    "BatchedStreamingServer.__init__": (jserver.BatchedStreamingServer.__init__,
                                        tserver.BatchedStreamingServer.__init__),
    "BatchLoader.__init__": (jloader.BatchLoader.__init__, tloader.BatchLoader.__init__),
    "SegDataset.__init__": (jds.SegDataset.__init__, tds.SegDataset.__init__),
    "evaluate": (jeval.evaluate, teval.evaluate),
    "random_affine": (jaug.random_affine, taug.random_affine),
    "copy_paste": (jaug.copy_paste, taug.copy_paste),
    "mosaic4": (jaug.mosaic4, taug.mosaic4),
    "flip_lr": (jaug.flip_lr, taug.flip_lr),
    "letterbox_np": (jaug.letterbox_np, taug.letterbox_np),
    "MockCamera.__init__": (jcam.MockCamera.__init__, tcam.MockCamera.__init__),
    "MockCamera.read": (jcam.MockCamera.read, tcam.MockCamera.read),
    "MockCamera.get": (jcam.MockCamera.get, tcam.MockCamera.get),
    "StageTimer.__init__": (jprof.StageTimer.__init__, tprof.StageTimer.__init__),
    "StageTimer.stage": (jprof.StageTimer.stage, tprof.StageTimer.stage),
    "StageTimer.add_sample": (jprof.StageTimer.add_sample, tprof.StageTimer.add_sample),
    "StageTimer.write": (jprof.StageTimer.write, tprof.StageTimer.write),
    "StageTimer.write_samples": (jprof.StageTimer.write_samples,
                                 tprof.StageTimer.write_samples),
    "device_trace": (jprof.device_trace, tprof.device_trace),
    "generate_cue_assets": (jtts.generate_cue_assets, ttts.generate_cue_assets),
    "render_cue": (jtts.render_cue, ttts.render_cue),
    "write_wav": (jtts.write_wav, ttts.write_wav),
    "synthesize": (jspeech.synthesize, tspeech.synthesize),
    "synthesize_phones": (jspeech.synthesize_phones, tspeech.synthesize_phones),
    "GoldenReplayPipeline.__init__": (jgolden.GoldenReplayPipeline.__init__,
                                      tgolden.GoldenReplayPipeline.__init__),
    "GoldenReplayPipeline.process": (jgolden.GoldenReplayPipeline.process,
                                     tgolden.GoldenReplayPipeline.process),
}
# Parameters the port may add after the JAX ones.
TRAILING_EXTRAS = {"device"}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parameters_in_the_jax_order(name):
    want, got = (list(inspect.signature(f).parameters.values()) for f in PAIRS[name])
    assert [p.name for p in got[:len(want)]] == [p.name for p in want], name
    assert {p.name for p in got[len(want):]} <= TRAILING_EXTRAS, name
    for a, b in zip(got, want):
        assert a.kind == b.kind, (name, a.name)
        assert a.default == b.default, (name, a.name, a.default, b.default)


@pytest.mark.parametrize("pair", [(jfp.FrameResult, tfp.FrameResult),
                                  (jaug.AugmentConfig, taug.AugmentConfig)],
                         ids=["FrameResult", "AugmentConfig"])
def test_dataclass_fields_in_the_jax_order(pair):
    want, got = (dataclasses.fields(c) for c in pair)
    assert [(f.name, f.default) for f in got] == [(f.name, f.default) for f in want]


def test_debug_raises_until_the_visualiser_is_ported():
    with pytest.raises(NotImplementedError, match="visualiser"):
        tfp.FrameProcessor(None, None, True, device="cpu")
    # A third positional False is debug, as in JAX, not replay_rounding.
    fp = tfp.FrameProcessor(None, None, False, True, device="cpu")
    assert fp._replay_rounding is True


def _flags(parser: argparse.ArgumentParser) -> list[tuple]:
    """(dest, option strings, default, required, choices, type, nargs, kind)
    of each argument but --help, in order."""
    return [(a.dest, tuple(a.option_strings), a.default, a.required, a.choices,
             a.type, a.nargs, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


def _subcommands(parser: argparse.ArgumentParser) -> dict:
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


# The one flag the port's command lines add, at the end of each.
DEVICE_FLAG = ("device", ("--device",), "cuda", False, None, None, None, "_StoreAction")


@pytest.mark.parametrize("command", ["video", "image", "replay"])
def test_cli_has_the_jax_flags_and_defaults(command):
    """Every JAX option in the JAX order with the JAX default (engine
    ``exact``, ``--transfer-format i420``, ``--every-n 15``, ``--depth 1``);
    ``--device`` is the only addition."""
    want = _flags(_subcommands(jmain.build_parser())[command])
    got = _flags(_subcommands(tmain.build_parser())[command])
    assert got == want + [DEVICE_FLAG]


def test_cli_subcommands_match_jax():
    jp, tp = jmain.build_parser(), tmain.build_parser()
    assert list(_subcommands(tp)) == list(_subcommands(jp)) == ["video", "image", "replay"]
    assert _flags(tp)[0][:4] == _flags(jp)[0][:4] == ("command", (), None, True)
    defaults = vars(tp.parse_args(["video", "--source", "x.npy"]))
    assert (defaults["engine"], defaults["transfer_format"], defaults["every_n"],
            defaults["depth"], defaults["device"]) == ("exact", "i420", 15, 1, "cuda")


def _script_flags(path: pathlib.Path) -> list[tuple]:
    """(option, keyword arguments) of each add_argument call in a script,
    read from its source (the JAX script builds its parser inside main)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            out.append((node.args[0].value,
                        {k.arg: ast.literal_eval(k.value) if not isinstance(k.value, ast.Name)
                         else k.value.id for k in node.keywords if k.arg != "help"}))
    return out


def test_export_model_has_the_jax_flags():
    want = _script_flags(REPO / "scripts" / "export_model.py")
    got = _script_flags(REPO / "vision_assist_tpu_torch" / "export_model.py")
    assert got == want + [("--device", {"default": "cuda"})]
    args = export_model.build_parser().parse_args(["--weights", "w", "--out", "o"])
    assert (args.arch, args.imgsz, tuple(args.frame_hw), args.device) == \
        ("yolov8n-seg", 640, (1280, 720), "cuda")


def test_departure_generate_goldens_requires_out():
    """The JAX script writes into tests/fixtures/goldens/; the port's has no
    default directory."""
    (out,) = [a for a in generate_goldens.build_parser()._actions if a.dest == "out"]
    assert out.required and out.default is None


def test_departure_mock_camera_sources(tmp_path):
    """An .npy stack or a PNG directory; an encoded video raises naming the
    decoder; the source rate is the target rate (30 when none is given)."""
    import numpy as np

    np.save(tmp_path / "f.npy", np.zeros((2, 4, 6, 3), np.uint8))
    cam = tcam.MockCamera(tmp_path / "f.npy", target_fps=12)
    assert (cam.frame_count, cam.frame_height, cam.frame_width, cam.original_fps) == \
        (2, 4, 6, 12.0)
    assert tcam.MockCamera(tmp_path / "f.npy").original_fps == 30.0
    (tmp_path / "clip.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(ValueError, match="decoder"):
        tcam.MockCamera(tmp_path / "clip.mp4")


def test_departure_image_reads_png_only(tmp_path):
    jpeg = tmp_path / "f.jpg"
    jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        tmain.main(["image", str(jpeg), "--device", "cpu"])
