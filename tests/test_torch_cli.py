"""The port's command line (``python -m vision_assist_tpu_torch.main``) and
its frame source ``MockCamera`` against the JAX package's, on the CPU.

* ``MockCamera``: clips are encoded with cv2 as ``tests/test_video_cli.py``
  builds them and decoded with cv2 here, and the frames stored as an .npy
  stack and as a directory of PNG files; the port reads the frames JAX's
  ``MockCamera`` reads from the clip, and paces reads as JAX's does.
* ``replay``: all 13 scenarios under ``exact``, ``exact_device`` and
  ``wavefront``: every printed line but the latency equal to JAX's.
* ``image``: two demo PNGs with the flagship: the printed lines equal.
* ``video``: the clip of ``tests/test_video_cli.py`` and a clip of seeded
  walkways (which the flagship detects), synchronously and at ``--depth 2``,
  with ``--tts-dir`` and ``--timing-data-path``: per-frame answers, cue
  names, stage names and the counts of the summary equal; times differ.
* Every entry point runs on the card unless asked for the CPU.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from vision_assist_tpu.io.mock_camera import MockCamera as JaxMockCamera  # noqa: E402
from vision_assist_tpu.io.scenarios import scenario_names  # noqa: E402
from vision_assist_tpu.main import main as jax_main  # noqa: E402
from vision_assist_tpu_torch import main as cli  # noqa: E402
from vision_assist_tpu_torch.io.mock_camera import MockCamera  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402

torch.set_num_threads(2)

DEMO = sorted((pathlib.Path(__file__).resolve().parents[1] / "assets" / "demo")
              .glob("*.png"))
CPU = ["--device", "cpu"]


def _run(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _trapezoid_frames():
    """The frames of tests/test_video_cli.py's clip: a bright trapezoid
    sliding sideways on 320x240."""
    out = []
    for t in range(60):
        frame = np.full((320, 240, 3), 30, np.uint8)
        shift = int(10 * np.sin(t / 10))
        pts = np.array([[80 + shift, 310], [160 + shift, 310],
                        [140 + shift, 60], [100 + shift, 60]], np.int32)
        cv2.fillPoly(frame, [pts], (180, 180, 180))
        out.append(frame)
    return out


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """name -> (the .mp4, its frames decoded by cv2 as .npy, as a PNG
    directory, the decoded frames)."""
    root = tmp_path_factory.mktemp("clips")
    out = {}
    for name, frames in (("trapezoid", _trapezoid_frames()),
                         ("walkways", list(walkway_frames(20, 320, 240, seed=4)))):
        path = root / f"{name}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (240, 320))
        assert writer.isOpened()
        for f in frames:
            writer.write(f)
        writer.release()
        cap = cv2.VideoCapture(str(path))
        decoded = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            decoded.append(f)
        cap.release()
        stack = np.stack(decoded)
        np.save(root / f"{name}.npy", stack)
        pngs = root / f"{name}_png"
        pngs.mkdir()
        for i, f in enumerate(decoded):
            assert cv2.imwrite(str(pngs / f"{i:04d}.png"), f)
        out[name] = (path, root / f"{name}.npy", pngs, stack)
    return out


def _read_all(cam):
    frames = []
    while cam.isOpened():
        ok, f = cam.read()
        if not ok:
            break
        frames.append(f)
    cam.release()
    return frames


@pytest.mark.parametrize("form", ["npy", "png"])
def test_mock_camera_reads_the_frames_jax_reads(clips, form):
    path, npy, pngs, _ = clips["trapezoid"]
    jcam = JaxMockCamera(path, target_fps=1000)
    cam = MockCamera(npy if form == "npy" else pngs, target_fps=1000)
    assert cam.isOpened()
    assert (cam.frame_width, cam.frame_height, cam.frame_count) == \
        (jcam.frame_width, jcam.frame_height, jcam.frame_count) == (240, 320, 60)
    for prop in (cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT,
                 cv2.CAP_PROP_FRAME_COUNT):
        assert cam.get(prop) == jcam.get(prop)
    # A recorded departure: a frame stack has no rate of its own, so the
    # source's rate is the target's (JAX reads the clip's 30).
    assert cam.get(cv2.CAP_PROP_FPS) == cam.original_fps == 1000.0
    assert cam.get(cv2.CAP_PROP_POS_MSEC) == 0.0
    got, want = _read_all(cam), _read_all(jcam)
    assert len(got) == len(want) == 60
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.flags.writeable
        np.testing.assert_array_equal(a, b)
    assert not cam.isOpened() and cam.read() == (False, None)


def test_mock_camera_default_rate(clips):
    cam = MockCamera(clips["trapezoid"][1])
    assert cam.original_fps == cam.target_fps == 30.0
    assert cam.frame_delay == pytest.approx(1 / 30)


def test_mock_camera_paces_frame_rate(clips):
    """As JAX's test_paces_frame_rate: 10 reads at 100 fps take >= 0.08 s."""
    import time

    cam = MockCamera(clips["trapezoid"][1], target_fps=100)
    t0 = time.time()
    for _ in range(10):
        cam.read()
    assert time.time() - t0 >= 0.08
    cam.release()


def test_mock_camera_refuses_an_encoded_video(clips, tmp_path):
    with pytest.raises(ValueError, match="decoder"):
        MockCamera(clips["trapezoid"][0])
    with pytest.raises(ValueError, match="Failed to open"):
        MockCamera(tmp_path / "missing.npy")
    with pytest.raises(ValueError, match="no PNG frames"):
        MockCamera(tmp_path)
    np.save(tmp_path / "grey.npy", np.zeros((2, 8, 8), np.uint8))
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\) uint8"):
        MockCamera(tmp_path / "grey.npy")


@pytest.mark.parametrize("name", scenario_names())
@pytest.mark.parametrize("engine", ["exact", "exact_device", "wavefront"])
def test_replay_prints_what_jax_prints(engine, name):
    """Peaks, path count and lengths, final answer: every line but the
    latency's."""
    argv = ["replay", name, "--engine", engine]
    got, want = _run(cli.main, argv + CPU), _run(jax_main, argv)
    assert got[-1].startswith("latency:") and want[-1].startswith("latency:")
    assert got[:-1] == want[:-1]
    assert len(got) == 6


def test_replay_of_an_unknown_scenario():
    argv = ["replay", "no_such_scenario"]
    buf, jbuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv + CPU) == 1
    with contextlib.redirect_stdout(jbuf):
        assert jax_main(argv) == 1
    assert buf.getvalue() == jbuf.getvalue()


def test_debug_raises_until_the_visualiser_is_ported():
    with pytest.raises(NotImplementedError, match="visualiser"):
        cli.main(["replay", "right_turn", "--debug"] + CPU)


@pytest.mark.parametrize("i", [2, 5])
def test_image_prints_what_jax_prints(i):
    """Two demo frames in which the flagship finds the walkway; JAX reads
    them with cv2.imread, the port with read_png."""
    got, want = _run(cli.main, ["image", str(DEMO[i])] + CPU), \
        _run(jax_main, ["image", str(DEMO[i])])
    assert got == want
    assert got[0].startswith("final answer: ")


def test_image_reads_png_only(tmp_path):
    """A recorded departure: no JPEG decoder, so a JPEG raises; a missing
    file is reported as JAX reports it."""
    jpeg = tmp_path / "frame.jpg"
    assert cv2.imwrite(str(jpeg), np.zeros((40, 40, 3), np.uint8))
    with pytest.raises(ValueError, match="JPEG"):
        cli.main(["image", str(jpeg)] + CPU)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["image", str(tmp_path / "none.png")] + CPU) == 1
    assert buf.getvalue() == f"cannot read {tmp_path / 'none.png'}\n"


_MS = re.compile(r" \(\d+\.\d ms\)")


def _normalised(lines, tts_dir):
    """The printed lines without times, the cue directory named DIR."""
    out = []
    for ln in lines:
        if ln.lstrip().startswith(("mean latency", "p50 latency", "throughput")):
            continue
        ln = _MS.sub("", ln)
        out.append(ln.replace(str(tts_dir), "DIR") if tts_dir else ln)
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("clip", ["trapezoid", "walkways"])
def test_video_matches_jax(clips, clip, depth, tmp_path):
    """The .mp4 through JAX's CLI, its decoded frames (.npy) through the
    port's, every 4th frame, the flagship and the default engine."""
    mp4, npy, _, _ = clips[clip]
    runs = {}
    for side, main, source in (("jax", jax_main, mp4), ("port", cli.main, npy)):
        d = tmp_path / side
        argv = ["video", "--source", str(source), "--every-n", "4",
                "--camera-fps", "10000", "--tts-dir", str(d / "cues"),
                "--depth", str(depth), "--timing-data-path", str(d / "timing.txt")]
        runs[side] = (_normalised(_run(main, argv + (CPU if side == "port" else [])),
                                  d / "cues"), d)
    (got, pd), (want, jd) = runs["port"], runs["jax"]
    assert got == want
    answered = [ln for ln in got if ln.startswith(("frame ", "answer "))]
    assert len(answered) == {"trapezoid": 15, "walkways": 5}[clip]
    if clip == "walkways":
        assert all("detections" not in ln and "[cue: DIR/" in ln for ln in answered)
    assert sorted(p.name for p in (pd / "cues").iterdir()) == \
        sorted(p.name for p in (jd / "cues").iterdir())
    if depth == 1:
        stages = [[ln for ln in (d / "timing.txt").read_text().splitlines()
                   if not ln.startswith(" ")] for d in (pd, jd)]
        assert stages[0] == stages[1] == ["frame:"]
    else:                  # both ignore the timing file when pipelined
        assert not (pd / "timing.txt").exists() and not (jd / "timing.txt").exists()


def test_video_reads_a_png_directory_as_the_npy_stack(clips):
    _, npy, pngs, _ = clips["walkways"]
    argv = ["video", "--every-n", "5", "--camera-fps", "10000"] + CPU
    a = _normalised(_run(cli.main, argv + ["--source", str(npy)]), None)
    b = _normalised(_run(cli.main, argv + ["--source", str(pngs)]), None)
    assert a == b and len([ln for ln in a if ln.startswith("frame ")]) == 4


@pytest.mark.parametrize("argv", [
    ["replay", "right_turn"],
    ["image", str(DEMO[0])],
    ["video", "--source", "SOURCE"],
], ids=["replay", "image", "video"])
def test_entry_points_default_to_the_card(clips, argv, monkeypatch):
    """Without --device the CLI asks for the card, and a missing card
    raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(clips["walkways"][1]) if a == "SOURCE" else a for a in argv]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


def test_bench_defaults_to_the_card(monkeypatch):
    from vision_assist_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_bench()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
