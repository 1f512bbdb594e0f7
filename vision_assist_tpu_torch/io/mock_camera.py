"""MockCamera: a frame source with frame-rate pacing.

API twin of the JAX package's MockCamera (itself the reference's), which
mirrors ``cv2.VideoCapture``: read()/get()/isOpened()/release(), sleeping
between reads to enforce a target FPS.

The port has no video decoder (no ``cv2``), so the source is either an
``.npy`` stack of frames, (N, H, W, 3) uint8 BGR, or a directory of PNG
frames, read in sorted order with ``io/png.py::read_png``. An encoded video
file raises ``ValueError``; decode it to one of those forms first.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np

from vision_assist_tpu_torch.io.png import read_png

# cv2.CAP_PROP_* ids that get() answers.
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_FRAME_COUNT = 7

DEFAULT_FPS = 30.0


class MockCamera:
    def __init__(self, video_path: str | pathlib.Path,
                 target_fps: float | None = None):
        path = pathlib.Path(video_path)
        if path.is_dir():
            self._files = sorted(path.glob("*.png"))
            if not self._files:
                raise ValueError(f"Failed to open video source: no PNG frames "
                                 f"in {path}")
            self._stack = None
            first = read_png(self._files[0])
            self.frame_count = len(self._files)
        elif path.suffix == ".npy" and path.is_file():
            self._files = None
            self._stack = np.load(path, mmap_mode="r")
            if self._stack.ndim != 4 or self._stack.shape[-1] != 3 \
                    or self._stack.dtype != np.uint8:
                raise ValueError(f"{path}: a frame stack is (N, H, W, 3) uint8, "
                                 f"got {self._stack.dtype} {self._stack.shape}")
            first = self._stack[0]
            self.frame_count = len(self._stack)
        elif path.is_file():
            raise ValueError(
                f"Failed to open video file: {path}: decoding an encoded video "
                "needs a video decoder (cv2.VideoCapture), which the port does "
                "not have; give an .npy frame stack (N, H, W, 3) uint8 or a "
                "directory of PNG frames")
        else:
            raise ValueError(f"Failed to open video file: {path}")
        self._next = 0
        self._open = True
        self.original_fps = (float(target_fps) if target_fps is not None
                             else DEFAULT_FPS)
        self.target_fps = self.original_fps
        self.frame_delay = 1.0 / self.target_fps if self.target_fps else 0.0
        self.last_frame_time = 0.0
        self.frame_height, self.frame_width = (int(x) for x in first.shape[:2])

    def _frame(self, i: int) -> np.ndarray:
        if self._stack is not None:
            return np.array(self._stack[i])
        return read_png(self._files[i])

    def read(self):
        elapsed = time.time() - self.last_frame_time
        if elapsed < self.frame_delay:
            time.sleep(self.frame_delay - elapsed)
        if not self._open or self._next >= self.frame_count:
            ret, frame = False, None
        else:
            ret, frame = True, self._frame(self._next)
            self._next += 1
        self.last_frame_time = time.time()
        return ret, frame

    def get(self, prop_id):
        """The value of a cv2 capture property: FPS, frame width, height and
        count; 0.0 for any other id, as cv2 answers one it does not know."""
        return float({CAP_PROP_FPS: self.original_fps,
                      CAP_PROP_FRAME_WIDTH: self.frame_width,
                      CAP_PROP_FRAME_HEIGHT: self.frame_height,
                      CAP_PROP_FRAME_COUNT: self.frame_count}.get(prop_id, 0.0))

    def isOpened(self):  # noqa: N802 - cv2 API compatibility
        return self._open

    def release(self):
        self._open = False
        self._stack = None
