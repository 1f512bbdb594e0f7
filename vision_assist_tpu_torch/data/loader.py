"""Batch loader: fixed-shape packing + ordered prefetch in worker threads.

Counterpart of ``vision_assist_tpu/data/loader.py``: the train step consumes
fully packed dense batches (BGR uint8 images or their I420 planes, overlap
masks, padded boxes, classes, valid flags, per-image HSV gains), so it never
sees a dynamic shape. The dataset is any object with ``records``,
``load_image(i)`` (BGR uint8) and ``__len__``.

Only the letterbox path (``augment=False``) is here. The augmenting loader
(mosaic, random affine, copy-paste, the HSV gains it draws) comes with the
next slice of the port; ``augment=True`` raises until then.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np

from vision_assist_tpu_torch.data.augment import letterbox_np
from vision_assist_tpu_torch.data.dataset import polygons_to_overlap_mask
from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host


class BatchLoader:
    def __init__(self, dataset: Any, batch_size: int = 16, imgsz: int = 640,
                 mask_ratio: int = 4, max_instances: int = 32,
                 augment: bool = True, seed: int = 0, prefetch: int = 4,
                 wire_format: str = "bgr"):
        if augment:
            raise NotImplementedError(
                "BatchLoader(augment=True) needs the augmentations (mosaic, "
                "random affine, copy-paste), which slice 6 of the port brings; "
                "pass augment=False")
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
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    # -- single sample -------------------------------------------------------------

    def _sample(self, idx: int) -> tuple[np.ndarray, list[np.ndarray], list[int]]:
        """One letterboxed sample: (image BGR, polygons in pixels, classes)."""
        rec = self.ds.records[idx]
        img = self.ds.load_image(idx)
        h, w = img.shape[:2]
        polys = [p * [w, h] for p in rec.polygons]
        img, polys = letterbox_np(img, polys, self.imgsz)

        # Drop degenerate polygons (fully clipped away).
        kept_polys, kept_classes = [], []
        for p, c in zip(polys, rec.classes):
            x1, y1 = p.min(axis=0)
            x2, y2 = p.max(axis=0)
            if (x2 - x1) > 2 and (y2 - y1) > 2:
                kept_polys.append(p)
                kept_classes.append(c)
        return img, kept_polys, kept_classes

    def _pack(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        b = len(idxs)
        s = self.imgsz
        mh, mw = self.mask_hw
        images = np.zeros((b, s, s, 3), np.uint8)
        masks = np.zeros((b, mh, mw), np.uint8)
        boxes = np.zeros((b, self.max_instances, 4), np.float32)
        classes = np.zeros((b, self.max_instances), np.int32)
        valid = np.zeros((b, self.max_instances), bool)
        for i, idx in enumerate(idxs):
            images[i], polys, cls = self._sample(int(idx))
            m, bx, cl, vd = polygons_to_overlap_mask(
                polys, np.asarray(cls, np.int32), (s, s), (mh, mw),
                self.max_instances)
            masks[i], boxes[i], classes[i], valid[i] = m, bx, cl, vd
        if self.wire_format == "i420":
            images = np.stack([bgr_to_i420_host(im) for im in images])
        # Images stay BGR: the train step flips channels on the device, with
        # the HSV jitter, whose gains are 1 without augmentation.
        return {"images": images, "masks": masks, "boxes": boxes,
                "classes": classes, "valid": valid,
                "hsv_gains": np.ones((b, 3), np.float32)}

    # -- iteration -------------------------------------------------------------------

    def epoch(self, shuffle: bool = True, workers: int = 4):
        """Yield packed batches in deterministic order; packing is spread over
        worker threads."""
        order = np.arange(len(self.ds))
        if shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        # The augmenting loader seeds each batch from these; drawn here too so
        # that the next epoch shuffles as the JAX loader's does.
        self.rng.integers(0, 2 ** 63 - 1, size=n_batches)

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
                packed = self._pack(idxs)
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
