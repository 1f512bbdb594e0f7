"""Batch loader: geometry augmentation, fixed-shape packing and ordered
prefetch in worker threads.

Counterpart of ``vision_assist_tpu/data/loader.py``: the train step consumes
fully packed dense batches (BGR uint8 images or their I420 planes, overlap
masks, padded boxes, classes, valid flags, per-image HSV gains), so it never
sees a dynamic shape. The dataset is any object with ``records``,
``load_image(i)`` (BGR uint8) and ``__len__``.

The host does geometry only (mosaic, random affine, copy-paste, the flip of
the polygons and the one strided copy that flips the pixels) and draws the
HSV gains; the train step applies them on the device
(``augment_device.py``). Every random draw comes from one
``np.random.Generator`` a batch, in the JAX loader's order, so a seed gives
the same polygons, masks, boxes, flips and gains as the JAX loader's.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np

from vision_assist_tpu_torch.data.augment import (
    AugmentConfig,
    copy_paste,
    flip_polys,
    letterbox_np,
    mosaic4,
    random_affine,
)
from vision_assist_tpu_torch.data.dataset import (  # noqa: F401 (SegDataset: JAX's name here)
    SegDataset,
    polygons_to_overlap_mask,
)
from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host


class BatchLoader:
    def __init__(self, dataset: Any, batch_size: int = 16, imgsz: int = 640,
                 mask_ratio: int = 4, max_instances: int = 32,
                 augment: bool = True, aug: AugmentConfig | None = None,
                 seed: int = 0, prefetch: int = 4, wire_format: str = "bgr"):
        if wire_format not in ("bgr", "i420"):
            raise ValueError(f"wire_format must be 'bgr' or 'i420', got {wire_format!r}")
        self.ds = dataset
        # "i420": images go as the (B, S*3/2, S) YUV 4:2:0 plane, half the
        # bytes of BGR; the train step converts back on the device.
        self.wire_format = wire_format
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.mask_hw = (imgsz // mask_ratio, imgsz // mask_ratio)
        self.max_instances = max_instances
        self.augment = augment
        self.aug = aug or AugmentConfig()
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        # The training driver clears this for the last epochs (close-mosaic).
        self.mosaic_enabled = augment and self.aug.mosaic > 0

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    # -- single sample -------------------------------------------------------------

    def _pixel_polys(self, idx: int) -> tuple[np.ndarray, list[np.ndarray]]:
        """Image ``idx`` and its polygons in pixels."""
        img = self.ds.load_image(idx)
        h, w = img.shape[:2]
        return img, [p * [w, h] for p in self.ds.records[idx].polygons]

    def _sample(self, idx: int, rng: np.random.Generator
                ) -> tuple[np.ndarray, list[np.ndarray], list[int],
                           bool, np.ndarray]:
        """One sample. Returns (image BGR, unflipped; polygons, flip already
        applied; classes; flip flag; HSV gains)."""
        img, polys = self._pixel_polys(idx)
        classes = list(self.ds.records[idx].classes)
        flip = False
        gains = np.ones(3, np.float32)

        if self.augment:
            if self.mosaic_enabled and rng.random() < self.aug.mosaic:
                extra = rng.integers(0, len(self.ds), 3)
                imgs, plists, clists = [img], [polys], [classes]
                for j in extra:
                    ij, pj = self._pixel_polys(int(j))
                    imgs.append(ij)
                    plists.append(pj)
                    clists.append(list(self.ds.records[int(j)].classes))
                img, polys = mosaic4(imgs, plists, rng, self.imgsz)
                classes = [c for cl in clists for c in cl]
            else:
                img, polys = letterbox_np(img, polys, self.imgsz)
            img, polys = random_affine(img, polys, rng, self.aug, self.imgsz)
            if self.aug.copy_paste > 0 and rng.random() < self.aug.copy_paste:
                j = int(rng.integers(0, len(self.ds)))
                dimg, dpolys = letterbox_np(*self._pixel_polys(j), self.imgsz)
                img, polys, classes = copy_paste(
                    img, polys, classes, dimg, dpolys,
                    list(self.ds.records[j].classes), rng)
            gains = (rng.uniform(-1, 1, 3)
                     * [self.aug.hsv_h, self.aug.hsv_s, self.aug.hsv_v]
                     + 1).astype(np.float32)
            if rng.random() < self.aug.fliplr:
                flip = True
                polys = flip_polys(polys, img.shape[1])
        else:
            img, polys = letterbox_np(img, polys, self.imgsz)

        # Drop degenerate polygons (fully clipped away).
        kept_polys, kept_classes = [], []
        for p, c in zip(polys, classes):
            x1, y1 = p.min(axis=0)
            x2, y2 = p.max(axis=0)
            if (x2 - x1) > 2 and (y2 - y1) > 2:
                kept_polys.append(p)
                kept_classes.append(c)
        return img, kept_polys, kept_classes, flip, gains

    def _pack(self, idxs: np.ndarray,
              rng: np.random.Generator | None = None) -> dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        b = len(idxs)
        s = self.imgsz
        mh, mw = self.mask_hw
        images = np.zeros((b, s, s, 3), np.uint8)
        masks = np.zeros((b, mh, mw), np.uint8)
        boxes = np.zeros((b, self.max_instances, 4), np.float32)
        classes = np.zeros((b, self.max_instances), np.int32)
        valid = np.zeros((b, self.max_instances), bool)
        hsv_gains = np.ones((b, 3), np.float32)
        for i, idx in enumerate(idxs):
            img, polys, cls, flip, gains = self._sample(int(idx), rng)
            # Images stay BGR: the train step flips channels on the device,
            # with the HSV jitter. The lr-flip is one strided copy here (the
            # polygons were flipped in _sample).
            images[i] = img[:, ::-1] if flip else img
            hsv_gains[i] = gains
            m, bx, cl, vd = polygons_to_overlap_mask(
                polys, np.asarray(cls, np.int32), (s, s), (mh, mw),
                self.max_instances)
            masks[i], boxes[i], classes[i], valid[i] = m, bx, cl, vd
        if self.wire_format == "i420":
            images = np.stack([bgr_to_i420_host(im) for im in images])
        return {"images": images, "masks": masks, "boxes": boxes,
                "classes": classes, "valid": valid, "hsv_gains": hsv_gains}

    # -- iteration -------------------------------------------------------------------

    def epoch(self, shuffle: bool = True, workers: int = 4):
        """Yield packed batches in deterministic order; packing (decode,
        augment, rasterise) is spread over worker threads, each batch with its
        own Generator, so the result does not depend on scheduling."""
        order = np.arange(len(self.ds))
        if shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        batch_seeds = self.rng.integers(0, 2 ** 63 - 1, size=n_batches)

        results: dict[int, dict] = {}
        next_needed = [0]
        cond = threading.Condition()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        window = max(self.prefetch, workers) + workers

        # Cooperative shutdown: a consumer that abandons the generator early
        # (break or close) must not strand the flusher on a full queue and the
        # workers in cond.wait, each holding a packed batch.
        stop = threading.Event()

        def worker(wid: int):
            for bi in range(wid, n_batches, workers):
                if stop.is_set():
                    return
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                packed = self._pack(idxs, np.random.default_rng(batch_seeds[bi]))
                with cond:
                    # Bounded reorder window relative to the flush head; the
                    # worker holding the head batch never waits, so this
                    # cannot deadlock.
                    while bi - next_needed[0] >= window and not stop.is_set():
                        cond.wait(timeout=1.0)
                    if stop.is_set():
                        return
                    results[bi] = packed
                    cond.notify_all()

        def flusher():
            for bi in range(n_batches):
                with cond:
                    while bi not in results and not stop.is_set():
                        cond.wait(timeout=1.0)
                    if stop.is_set():
                        return
                    packed = results.pop(bi)
                    next_needed[0] = bi + 1
                    cond.notify_all()
                while not stop.is_set():  # blocks on queue backpressure
                    try:
                        q.put(packed, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(None)

        for w in range(workers):
            threading.Thread(target=worker, args=(w,), daemon=True).start()
        flusher_t = threading.Thread(target=flusher, daemon=True)
        flusher_t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            # Drain until the flusher has exited: its in-flight q.put can
            # succeed after a single drain, holding one packed batch until
            # the thread notices stop.
            deadline = 5.0
            while True:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                if not flusher_t.is_alive() or deadline <= 0:
                    break
                flusher_t.join(timeout=0.2)
                deadline -= 0.2
            results.clear()
