"""Where the augmenting loader's time goes on the host.

    python -m vision_assist_tpu_torch.utils.profile_loader [--images 64] [--repeat 8]
        [--imgsz 256] [--batch 16] [--workers 6 3 2 1]

Writes ``--images`` synthetic walkways of 640x640 as a PNG dataset under
runs/profile_loader (removed after), reads it as the training driver does
(``SegDataset(cache_images=imgsz)``), and runs ``BatchLoader(augment=True)``
with the driver's recipe over an epoch of ``--repeat`` passes of the set, so
that every worker thread packs several batches, once for each worker count.
Prints one JSON object: for each worker count, ms a batch (over the epoch,
and after the first batch), the host CPU seconds over the wall seconds (how
many cores the threads kept busy), and each part of a sample: its ms a batch,
summed over the threads, and its ms a call. A part whose ms a call grows with
the worker count waits while the threads run; one that holds the interpreter
lock keeps the CPU share near 1. Needs no card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import pathlib
import shutil
import sys
import threading
import time
from typing import Any

from vision_assist_tpu_torch.data import augment as augment_mod
from vision_assist_tpu_torch.data import loader as loader_mod
from vision_assist_tpu_torch.data.augment import AugmentConfig

# The calls of BatchLoader._sample and _pack, by the name the loader module
# looks up; then the helpers inside them, by the augment module's names.
TOP_PARTS = ("mosaic4", "letterbox_np", "random_affine", "copy_paste",
             "polygons_to_overlap_mask")
INNER_PARTS = ("_resize_bilinear", "_warp", "fill_poly")


class _Repeat:
    """``ds`` ``times`` over, as one dataset."""

    def __init__(self, ds: Any, times: int):
        self.ds = ds
        self.records = list(ds.records) * times

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, i: int):
        return self.ds.load_image(i % len(self.ds))


class _Clock:
    """Seconds and calls of each wrapped function, summed over threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.secs: dict[str, float] = collections.defaultdict(float)
        self.calls: dict[str, int] = collections.defaultdict(int)

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.secs[name] += dt
                    self.calls[name] += 1
        return timed


@contextlib.contextmanager
def _timed_parts(clock: _Clock):
    saved = [(loader_mod.BatchLoader, "_pack")]
    saved += [(loader_mod, n) for n in TOP_PARTS]
    saved += [(augment_mod, n) for n in INNER_PARTS]
    originals = [getattr(owner, n) for owner, n in saved]
    for (owner, n), fn in zip(saved, originals):
        setattr(owner, n, clock.wrap(n, fn))
    try:
        yield
    finally:
        for (owner, n), fn in zip(saved, originals):
            setattr(owner, n, fn)


def profile(ds: Any, imgsz: int, batch: int, workers: tuple[int, ...],
            repeat: int = 8, aug: AugmentConfig | None = None) -> dict[str, Any]:
    """The loader (bgr wire) over ``repeat`` passes of ``ds`` at each worker
    count."""
    out: dict[str, Any] = {}
    for n_workers in workers:
        clock = _Clock()
        data = _Repeat(ds, repeat)
        data.load_image = clock.wrap("load_image", data.load_image)
        loader = loader_mod.BatchLoader(data, batch_size=batch, imgsz=imgsz,
                                        augment=True, aug=aug or AugmentConfig(),
                                        seed=0)
        with _timed_parts(clock):
            cpu0, t0 = time.process_time(), time.perf_counter()
            n, t_first = 0, 0.0
            for _ in loader.epoch(workers=n_workers):
                n += 1
                if n == 1:
                    t_first = time.perf_counter()
            wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
        top = sum(clock.secs[p] for p in TOP_PARTS + ("load_image",))
        parts = {p: {"ms_a_batch": clock.secs[p] * 1e3 / n,
                     "ms_a_call": clock.secs[p] * 1e3 / max(clock.calls[p], 1),
                     "calls": clock.calls[p]}
                 for p in ("_pack", "load_image") + TOP_PARTS + INNER_PARTS}
        parts["rest_of_pack"] = {"ms_a_batch": (clock.secs["_pack"] - top) * 1e3 / n}
        out[str(n_workers)] = {
            "batches": n, "ms_a_batch": wall * 1e3 / n,
            "ms_a_batch_after_first": (wall - (t_first - t0)) * 1e3 / max(n - 1, 1),
            "first_batch_ms": (t_first - t0) * 1e3,
            "cpu_over_wall": cpu / wall, "parts": parts}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--imgsz", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, nargs="+", default=[6, 3, 2, 1])
    args = ap.parse_args(argv)

    from vision_assist_tpu_torch.data.dataset import SegDataset
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet, write_split

    work = pathlib.Path(__file__).resolve().parents[2] / "runs" / "profile_loader"
    shutil.rmtree(work, ignore_errors=True)
    try:
        write_split(WalkwaySet(args.images, 640, 640, seed=300), work, "train")
        ds = SegDataset(work, "train", cache_images=args.imgsz)
        result = profile(ds, args.imgsz, args.batch, tuple(args.workers), args.repeat)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"host_cores": len(os.sched_getaffinity(0)), "imgsz": args.imgsz,
                      "batch": args.batch, "images": args.images * args.repeat,
                      "workers": result}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
