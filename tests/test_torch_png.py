"""Port parity: the PNG reader and writer (``io/png.py``) against OpenCV.

``read_png`` must equal ``cv2.imread`` (BGR, alpha dropped, grey spread to
three channels) exactly, on the six demo frames (the Sub filter on every
row), on files written by PIL (adaptive filters, Paeth among them), by
``cv2.imwrite`` and by an encoder written out from the specification with all
five row filters, in images down to one pixel wide or one row high;
``write_png`` must read back equal through ``cv2.imread``. The formats it
does not read raise, naming what is missing.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from vision_assist_tpu_torch.io import png  # noqa: E402
from vision_assist_tpu_torch.io.png import read_png, write_png  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402

DEMO = sorted((pathlib.Path(__file__).resolve().parents[1] / "assets" / "demo").glob("*.png"))


def test_there_are_six_demo_frames():
    assert len(DEMO) == 6


@pytest.mark.parametrize("path", DEMO, ids=lambda p: p.name[:14])
def test_read_png_equals_imread_on_the_demo_frames(path):
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (640, 640, 3)
    np.testing.assert_array_equal(got, cv2.imread(str(path)))


def _frame(seed: int, h: int = 120, w: int = 160) -> np.ndarray:
    return walkway_frames(1, h, w, seed=seed)[0]


def _smooth(seed: int, h: int = 90, w: int = 130) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (15, 15), 0)


def _filters(path: pathlib.Path) -> set[int]:
    """The row filters a PNG file uses."""
    data = path.read_bytes()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, colour = header[:4]
    ch = {0: 1, 2: 3, 6: 4}[colour]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("make", [_frame, _smooth])
def test_read_png_equals_imread_on_pil_files(tmp_path, mode, make):
    bgr = make(3)
    img = Image.fromarray(np.ascontiguousarray(bgr[..., ::-1]))
    if mode == "RGBA":
        img = img.convert("RGBA")
        img.putalpha(Image.fromarray(np.full(bgr.shape[:2], 77, np.uint8)))
    elif mode == "L":
        img = img.convert("L")
    path = tmp_path / "pil.png"
    img.save(path)
    np.testing.assert_array_equal(read_png(path), cv2.imread(str(path)))


def test_pil_files_use_the_paeth_filter(tmp_path):
    """The PIL files above mix filters, Paeth among them."""
    seen = set()
    for seed in range(3):
        for make in (_frame, _smooth):
            path = tmp_path / f"{seed}.png"
            Image.fromarray(np.ascontiguousarray(make(seed)[..., ::-1])).save(path)
            seen |= _filters(path)
    assert 4 in seen and len(seen) >= 3, seen


def _encode(samples: np.ndarray, types: list[int]) -> bytes:
    """A PNG of (H, W, C) uint8 samples with the given filter on each row,
    the filters written out pixel by pixel from the PNG specification."""
    h, w, ch = samples.shape
    x = samples.astype(int).reshape(h, w * ch)
    lines = bytearray()
    for r in range(h):
        lines.append(types[r])
        for i in range(w * ch):
            a = x[r, i - ch] if i >= ch else 0
            b = x[r - 1, i] if r else 0
            c = x[r - 1, i - ch] if r and i >= ch else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth, 0)[types[r]]   # 5: no such filter
            lines.append((x[r, i] - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(lines))) + chunk(b"IEND", b""))


TYPES = [0, 1, 2, 3, 4, 4, 3, 3, 2, 1, 0, 4, 1, 3, 0, 2, 4, 4, 4, 3, 1, 2, 0]


@pytest.mark.parametrize("hw", [(23, 17), (23, 1), (1, 17), (1, 1)])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_read_png_undoes_every_filter(tmp_path, ch, hw):
    """Rows filtered with each of the five filters, in runs and alternating,
    against cv2.imread and against the samples themselves; in images one
    pixel wide (every row's left neighbour is the zero before it) and one row
    high (every row above is zero) too."""
    rng = np.random.default_rng(ch)
    samples = rng.integers(0, 256, (*hw, ch), np.uint8)
    types = TYPES[:hw[0]] if hw[0] > 1 else [4]
    path = tmp_path / "filters.png"
    path.write_bytes(_encode(samples, types))
    assert _filters(path) == set(types)
    got = read_png(path)
    np.testing.assert_array_equal(got, cv2.imread(str(path)))
    want = np.repeat(samples, 3, 2) if ch == 1 else samples[..., 2::-1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_read_png_equals_imread_on_imwrite_files(tmp_path, seed):
    path = tmp_path / "cv.png"
    cv2.imwrite(str(path), _frame(seed, 97, 131))
    np.testing.assert_array_equal(read_png(path), cv2.imread(str(path)))


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (640, 640)])
def test_write_png_reads_back_equal_through_imread(tmp_path, shape):
    bgr = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), np.uint8)
    path = tmp_path / "mine.png"
    write_png(path, bgr)
    np.testing.assert_array_equal(cv2.imread(str(path)), bgr)
    np.testing.assert_array_equal(read_png(path), bgr)


def _with_header(src: pathlib.Path, dst: pathlib.Path, **fields) -> None:
    """Copy a PNG with IHDR fields replaced (CRC recomputed)."""
    data = bytearray(src.read_bytes())
    names = ("width", "height", "depth", "colour", "compression", "filter", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    data[16:29] = struct.pack(">IIBBBBB", *(values[n] for n in names))
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    dst.write_bytes(bytes(data))


def test_unsupported_formats_raise(tmp_path):
    rgb = np.ascontiguousarray(_frame(1)[..., ::-1])
    Image.fromarray(rgb).convert("P").save(tmp_path / "palette.png")
    Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(tmp_path / "sixteen.png")
    cv2.imwrite(str(tmp_path / "frame.jpg"), _frame(1))
    write_png(tmp_path / "plain.png", _frame(1))
    _with_header(tmp_path / "plain.png", tmp_path / "adam7.png", interlace=1)
    Image.fromarray(rgb).convert("LA").save(tmp_path / "grey_alpha.png")
    for name, what in (("palette.png", "palette"), ("sixteen.png", "16-bit"),
                       ("frame.jpg", "JPEG"), ("adam7.png", "Adam7"),
                       ("grey_alpha.png", "grey with alpha")):
        with pytest.raises(ValueError, match=what):
            read_png(tmp_path / name)
    data = bytearray((tmp_path / "plain.png").read_bytes())
    data[40] ^= 0xFF                                  # inside the IDAT
    (tmp_path / "torn.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "torn.png")
    samples = np.zeros((3, 4, 3), np.uint8)
    (tmp_path / "filter5.png").write_bytes(_encode(samples, [1, 5, 0]))
    with pytest.raises(ValueError, match="row filter 5 does not exist"):
        read_png(tmp_path / "filter5.png")
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", np.zeros((4, 4, 3), np.float32))


def test_image_data_split_over_several_idat_chunks(tmp_path):
    """The compressed stream may be cut anywhere between IDAT chunks."""
    bgr = _frame(4)
    write_png(tmp_path / "one.png", bgr)
    data = (tmp_path / "one.png").read_bytes()
    (n,) = struct.unpack(">I", data[33:37])
    assert data[37:41] == b"IDAT"
    body = data[41:41 + n]
    cuts = [0, 1, 2, n // 3, n - 1, n]

    def chunk(kind, part):
        return (struct.pack(">I", len(part)) + kind + part
                + struct.pack(">I", zlib.crc32(kind + part)))

    split = (data[:33] + b"".join(chunk(b"IDAT", body[a:b]) for a, b in zip(cuts, cuts[1:]))
             + data[45 + n:])
    (tmp_path / "split.png").write_bytes(split)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "split.png")), bgr)
    np.testing.assert_array_equal(read_png(tmp_path / "split.png"), bgr)


def test_reader_without_a_compiler_raises_naming_it(tmp_path, monkeypatch):
    """No slower path runs in its place: without g++ the reader says so."""
    write_png(tmp_path / "x.png", _frame(2))
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+ to build png_unfilter.cpp"):
        read_png(tmp_path / "x.png")
