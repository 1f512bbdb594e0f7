"""The port's own bitmap font for the overlay's corner labels.

The JAX overlay writes each label with ``cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, 0.5, colour, 2)``. OpenCV's Hershey strokes are not
in the port, so :func:`put_text` draws the same text at the same origin in
glyphs of its own: 5 columns by 7 rows above the baseline and 2 below,
stretched to the Hershey cap height at the label's scale and thickened by
one pixel to the right. Each glyph is centred in the Hershey advance of
its character, so the label spans the text's Hershey width. Every pixel
lies inside :func:`label_box`, which holds the box ``cv2.getTextSize``
gives the text and every pixel ``cv2.putText`` writes for it. A recorded
departure: the pixels of a label differ from OpenCV's, the rest of the
overlay does not.
"""

from __future__ import annotations

import numpy as np

# Width of each printable ASCII character (32..126) in FONT_HERSHEY_SIMPLEX
# units: what cv2.getTextSize reports for the character alone at scale 1 and
# thickness 0 (its Hershey advance, or within a unit of it).
_ADVANCE = dict(zip(map(chr, range(32, 127)), (
    8, 8, 11, 21, 18, 22, 21, 7, 18, 18, 13, 18, 8, 14, 8, 14, 18, 18, 18, 18,
    18, 18, 18, 18, 18, 18, 8, 8, 15, 17, 15, 16, 25, 20, 20, 20, 20, 18, 17,
    20, 21, 8, 19, 18, 17, 23, 21, 20, 19, 20, 19, 18, 17, 21, 19, 24, 19, 19,
    18, 10, 14, 10, 13, 22, 10, 16, 18, 16, 18, 17, 12, 18, 18, 7, 8, 15, 8, 26,
    18, 17, 18, 18, 11, 15, 12, 18, 16, 24, 16, 16, 15, 11, 7, 11, 17)))
CAP_UNITS = 21          # the Hershey cap height
ASCENT_UNITS = 25       # the highest stroke above the baseline ('|', '(')
DESCENT_UNITS = 7       # the lowest stroke below it ('g', 'p', 'y')
WIDTH_SLACK = 3         # OpenCV 5's width past the Hershey width, at most

# Nine rows a glyph: seven above the baseline, two below it.
_GLYPHS = {
    " ": ".....|.....|.....|.....|.....|.....|.....|.....|.....",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.|.....|.....",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.|.....|.....",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####|.....|.....",
    "3": "####.|....#|....#|.###.|....#|....#|####.|.....|.....",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.|.....|.....",
    "5": "#####|#....|####.|....#|....#|#...#|.###.|.....|.....",
    "6": ".###.|#....|#....|####.|#...#|#...#|.###.|.....|.....",
    "7": "#####|....#|...#.|..#..|.#...|.#...|.#...|.....|.....",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.|.....|.....",
    "9": ".###.|#...#|#...#|.####|....#|....#|.###.|.....|.....",
    "a": ".....|.....|.###.|....#|.####|#...#|.####|.....|.....",
    "b": "#....|#....|####.|#...#|#...#|#...#|####.|.....|.....",
    "c": ".....|.....|.###.|#....|#....|#....|.###.|.....|.....",
    "d": "....#|....#|.####|#...#|#...#|#...#|.####|.....|.....",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.|.....|.....",
    "f": "..##.|.#...|####.|.#...|.#...|.#...|.#...|.....|.....",
    "g": ".....|.....|.####|#...#|#...#|.####|....#|#...#|.###.",
    "h": "#....|#....|####.|#...#|#...#|#...#|#...#|.....|.....",
    "i": "..#..|.....|.##..|..#..|..#..|..#..|.###.|.....|.....",
    "j": "...#.|.....|..##.|...#.|...#.|...#.|...#.|#..#.|.##..",
    "k": "#....|#....|#..#.|#.#..|##...|#.#..|#..#.|.....|.....",
    "l": ".##..|..#..|..#..|..#..|..#..|..#..|.###.|.....|.....",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#.#.#|#.#.#|.....|.....",
    "n": ".....|.....|####.|#...#|#...#|#...#|#...#|.....|.....",
    "o": ".....|.....|.###.|#...#|#...#|#...#|.###.|.....|.....",
    "p": ".....|.....|####.|#...#|#...#|####.|#....|#....|#....",
    "q": ".....|.....|.####|#...#|#...#|.####|....#|....#|....#",
    "r": ".....|.....|#.##.|##..#|#....|#....|#....|.....|.....",
    "s": ".....|.....|.####|#....|.###.|....#|####.|.....|.....",
    "t": ".#...|.#...|####.|.#...|.#...|.#..#|..##.|.....|.....",
    "u": ".....|.....|#...#|#...#|#...#|#..##|.##.#|.....|.....",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|..#..|.....|.....",
    "w": ".....|.....|#...#|#.#.#|#.#.#|#.#.#|.#.#.|.....|.....",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#|.....|.....",
    "y": ".....|.....|#...#|#...#|#...#|.####|....#|#...#|.###.",
    "z": ".....|.....|#####|...#.|..#..|.#...|#####|.....|.....",
    "-": ".....|.....|.....|#####|.....|.....|.....|.....|.....",
    "_": ".....|.....|.....|.....|.....|.....|.....|.....|#####",
    ".": ".....|.....|.....|.....|.....|.##..|.##..|.....|.....",
    ":": ".....|.##..|.##..|.....|.##..|.##..|.....|.....|.....",
}
# Any other character is drawn as an empty box.
_MISSING = "#####|#...#|#...#|#...#|#...#|#...#|#####|.....|....."
_BITMAPS = {c: np.array([[ch == "#" for ch in row] for row in g.split("|")])
            for c, g in {**_GLYPHS, None: _MISSING}.items()}


def text_width(text: str, scale: float, thickness: int) -> int:
    """The Hershey width of a line of text: its advances at the scale plus
    the thickness (OpenCV 4's ``getTextSize``; OpenCV 5 measures the glyphs'
    strokes and gives up to 4 pixels less or 3 more)."""
    return int(np.rint(sum(_ADVANCE.get(c, _ADVANCE["?"]) for c in text) * scale
                       + thickness))


def label_box(text: str, org: tuple[int, int], scale: float,
              thickness: int) -> tuple[int, int, int, int]:
    """(x0, y0, x1, y1), half-open, of the pixels that ``cv2.putText`` or
    :func:`put_text` may write for ``text`` with its baseline's left end at
    ``org``; it may reach past the image."""
    x, y = int(org[0]), int(org[1])
    return (x - thickness, y - int(np.ceil(ASCENT_UNITS * scale)) - thickness,
            x + text_width(text, scale, thickness) + thickness + WIDTH_SLACK,
            y + int(np.ceil(DESCENT_UNITS * scale)) + thickness + 1)


def put_text(img: np.ndarray, text: str, org: tuple[int, int], scale: float,
             colour, thickness: int) -> None:
    """Write ``text`` on a (H, W, C) uint8 image in place, its baseline's
    left end at ``org``, clipped at the image edge and at the label box."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = label_box(text, org, scale, thickness)
    cap = max(int(np.rint(CAP_UNITS * scale)), 7)
    row_px = cap / 7.0
    rows = int(np.ceil(9 * row_px))
    top = int(org[1]) - cap
    pen = float(org[0])
    for c in text:
        advance = _ADVANCE.get(c, _ADVANCE["?"]) * scale
        bitmap = _BITMAPS.get(c, _BITMAPS[None])
        left = int(np.rint(pen + (advance - 5 - (thickness - 1)) / 2))
        for py in range(rows):
            gy = min(int(py / row_px), 8)
            yy = top + py
            if not (max(y0, 0) <= yy < min(y1, h)):
                continue
            for gx in np.flatnonzero(bitmap[gy]):
                xa = max(left + int(gx), x0, 0)
                xb = min(left + int(gx) + thickness, x1, w)
                if xa < xb:
                    img[yy, xa:xb] = colour
        pen += advance
