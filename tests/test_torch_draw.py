"""The port's rasterisation (``io/draw.py``) and label font (``io/font.py``)
against ``cv2`` itself, pixel for pixel, on seeded cases.

* ``line`` at thickness 2 (the overlay's), and 3 to 5: horizontal, vertical,
  diagonal, length-0, general and off-image segments, on a 60x80 image so
  that many cross its edge;
* filled ``circle`` at the overlay's radii 5 and 8, and others, centres on,
  near and past the edge;
* ``line8`` (OpenCV's one-pixel line) against ``cv2.line`` with shift 0;
* the label box holds ``cv2.getTextSize``'s box, every pixel ``cv2.putText``
  writes and the port's own glyphs, on the overlay's labels and random text.
"""

from __future__ import annotations

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vision_assist_tpu_torch.io import draw, font  # noqa: E402

H, W = 60, 80
WHITE = (255, 255, 255)


def _segments(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.integers(-5, [W + 5, H + 5])
        if kind == "horizontal":
            q = np.array([rng.integers(-5, W + 5), p[1]])
        elif kind == "vertical":
            q = np.array([p[0], rng.integers(-5, H + 5)])
        elif kind == "diagonal":
            d = int(rng.integers(-30, 30))
            q = p + np.array([d, d * int(rng.choice([-1, 1]))])
        elif kind == "length0":
            q = p.copy()
        elif kind == "general":
            p, q = rng.integers(0, [W, H]), rng.integers(0, [W, H])
        else:                                   # off-image, far past the edge
            p, q = rng.integers(-40, [W + 40, H + 40]), rng.integers(-40, [W + 40, H + 40])
        out.append((tuple(int(v) for v in p), tuple(int(v) for v in q)))
    return out


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["horizontal", "vertical", "diagonal", "length0",
                                  "general", "off_image"])
def test_line_equals_cv2(kind, thickness):
    n = 200 if thickness == 2 else 40
    for p, q in _segments(kind, n, seed=thickness):
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        cv2.line(want, p, q, WHITE, thickness)
        draw.line(got, p, q, WHITE, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p} -> {q}")


def test_line_rejects_thickness_1():
    with pytest.raises(ValueError, match="thickness"):
        draw.line(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3), WHITE, 1)


@pytest.mark.parametrize("radius", [0, 1, 2, 5, 8, 13])
def test_filled_circle_equals_cv2(radius):
    rng = np.random.default_rng(radius)
    for _ in range(150):
        c = tuple(int(v) for v in rng.integers(-15, [W + 15, H + 15]))
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, c, radius, (255, 0, 255), -1)
        draw.circle(got, c, radius, (255, 0, 255))
        np.testing.assert_array_equal(got, want, err_msg=str(c))


def test_line8_equals_cv2():
    rng = np.random.default_rng(7)
    for _ in range(300):
        p = [int(v) for v in rng.integers(-30, [W + 30, H + 30])]
        q = [int(v) for v in rng.integers(-30, [W + 30, H + 30])]
        want = np.zeros((H, W), np.uint8)
        got = want.copy()
        cv2.line(want, p, q, 255, 1)
        draw.line8(got, p, q, 255)
        np.testing.assert_array_equal(got, want, err_msg=f"{p} -> {q}")


LABELS = ["1 right inner sharp", "2 left outer sweeping", "3 left optimal sharp",
          "12 right outer sweeping", "gjpqy|()", "A-Z_0.9:"]


def _random_texts(n: int) -> list[str]:
    rng = np.random.default_rng(3)
    chars = [chr(c) for c in range(32, 127)]
    return ["".join(rng.choice(chars, int(rng.integers(1, 25)))) for _ in range(n)]


@pytest.mark.parametrize("text", LABELS + _random_texts(20))
def test_label_box_holds_cv2_text_and_the_port_glyphs(text):
    """The departure is confined: the label box holds the box
    cv2.getTextSize gives, every pixel cv2.putText writes and every pixel of
    the port's glyphs, which are white and not empty."""
    org = (30, 40)
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 2)
    x0, y0, x1, y1 = font.label_box(text, org, 0.5, 2)
    assert x0 <= org[0] and org[0] + w <= x1 and y0 <= org[1] - h and org[1] + base < y1
    inside = np.zeros((100, 260), bool)
    inside[y0:y1, x0:x1] = True
    want = np.zeros((100, 260, 3), np.uint8)
    got = want.copy()
    cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, WHITE, 2)
    font.put_text(got, text, org, 0.5, WHITE, 2)
    assert want[~inside].max() == 0 and got[~inside].max() == 0
    assert (got.any(-1) == got.all(-1)).all()          # white or untouched
    if text.strip():
        assert got.any()


def test_text_is_clipped_at_the_image_edge():
    img = np.zeros((20, 30, 3), np.uint8)
    font.put_text(img, "1 right outer sharp", (-40, 5), 0.5, WHITE, 2)
    assert img.any()                                     # partly visible, no error
