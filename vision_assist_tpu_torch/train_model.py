"""Train the YOLO-seg model on a dataset directory: the counterpart of
``scripts/train_model.py``.

    python -m vision_assist_tpu_torch.train_model --data DIR --epochs 100 \\
        --batch 32 --out runs/seg1 [--arch yolov8n-seg] [--eval-every 10]

``DIR`` has the Roboflow layout (``{train,valid}/{images,labels}``) with PNG
images. The recipe is the reference's: SGD, the augmenting loader with mosaic
until the last ``--close-mosaic`` epochs, the EMA evaluated on the valid split
every ``--eval-every`` epochs and at the last. The run writes ``args.json``,
``history.json`` (one record an epoch), ``best.msgpack`` (the EMA at the best
mask mAP50) and ``last.msgpack`` into ``--out``, and with
``--save-state-every`` the full training state (``state``, the one before it
``state_prev``) for ``--resume-state``. The model computes in bf16 with
float32 parameters, on the card unless ``--device cpu``.

Exit code 42 asks a supervisor to restart the run with ``--resume-state``:
no step finished within ``--watchdog-secs``, or the host's resident memory
passed ``--max-rss-gb``.

Several processes train one model data-parallel when ``VAT_COORDINATOR`` is
set (``parallel/distributed.py``: with ``VAT_NUM_PROCESSES`` and
``VAT_PROCESS_ID``; NCCL on the cards, gloo with ``--device cpu``): each rank
loads ``--batch / processes`` images a step from its own seed, the step is
``parallel/train_step.py``'s (the single-process step on the global batch),
and only rank 0 evaluates and writes the history and the checkpoints.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import pathlib
import sys
import threading
import time
from typing import Any

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True,
                    help="dataset directory ({train,valid}/{images,labels})")
    ap.add_argument("--arch", default="yolov8n-seg")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--lr0", type=float, default=0.01)
    ap.add_argument("--close-mosaic", type=int, default=10)
    # Recipe levers (default 0 = the reference recipe exactly).
    ap.add_argument("--copy-paste", type=float, default=0.0,
                    help="per-sample probability of pasting donor instances")
    ap.add_argument("--degrees", type=float, default=0.0,
                    help="random rotation range (deg)")
    ap.add_argument("--shear", type=float, default=0.0,
                    help="random shear range (deg)")
    ap.add_argument("--perspective", type=float, default=0.0,
                    help="random projective coefficient range (~0.0005)")
    ap.add_argument("--train-split", default="train",
                    help="training split(s); 'train+test' adds the labelled "
                         "test frames (valid stays eval-only)")
    ap.add_argument("--wire-format", choices=["bgr", "i420"], default="bgr",
                    help="batch image format; i420 sends half the bytes and "
                         "converts on the device")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--eval-images", type=int, default=256)
    ap.add_argument("--out", default="runs/seg")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--cache-images", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="keep decoded images in memory (--no-cache-images "
                         "for datasets larger than the host's memory)")
    ap.add_argument("--resume", default=None,
                    help="msgpack checkpoint to initialise params and EMA from")
    ap.add_argument("--resume-state", default=None,
                    help="training state file for an exact resume "
                         "(params, EMA, batch stats, momentum, step)")
    ap.add_argument("--save-state-every", type=int, default=0,
                    help="save the full training state every N epochs")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="wait for the device every N steps (bounds the "
                         "queue of steps in flight)")
    ap.add_argument("--max-rss-gb", type=float, default=60.0,
                    help="exit 42 (restart and resume) when the host's "
                         "resident memory exceeds this")
    ap.add_argument("--watchdog-secs", type=int, default=600,
                    help="exit 42 if no step completes for this long")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap


def collapse_decision(history: list[dict[str, Any]], mean: dict[str, float],
                      state_avail: bool) -> tuple[bool, float, float]:
    """The collapse guard: whether this epoch's mean metrics show a collapse
    (a non-finite loss, foreground anchors per image below half the median,
    or a loss above 1.6 times the median of the healthy epochs among the
    last 8), with those medians. It judges only with at least 4 healthy
    epochs and a saved state to revert to; otherwise (False, nan, nan)."""
    healthy = [h for h in history[-8:] if not h.get("reverted")]
    if len(healthy) < 4 or not state_avail:
        return False, math.nan, math.nan
    med_loss = float(np.median([h["loss"] for h in healthy]))
    med_fg = float(np.median([h["fg_per_img"] for h in healthy]))
    collapsed = (not np.isfinite(mean["loss"])
                 or mean["fg_per_img"] < 0.5 * med_fg
                 or mean["loss"] > 1.6 * med_loss)
    return bool(collapsed), med_loss, med_fg


def _write_history(out: pathlib.Path, history: list[dict[str, Any]]) -> None:
    # Through a rename: a reader never sees a torn file.
    tmp = out / "history.json.tmp"
    tmp.write_text(json.dumps(history, indent=1))
    tmp.replace(out / "history.json")


def _rotate_state(out: pathlib.Path, state) -> None:
    """Write the state as ``state``, the previous one kept as ``state_prev``:
    written new, then swapped, so a crash mid-save never leaves a torn file
    where --resume-state expects one."""
    from vision_assist_tpu_torch.models.checkpoint import save_train_state

    new, cur, prev = out / "state_new", out / "state", out / "state_prev"
    new.unlink(missing_ok=True)
    save_train_state(new, state)
    prev.unlink(missing_ok=True)
    if cur.exists():
        cur.rename(prev)
    new.rename(cur)


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_model: CUDA requested but not available; "
                           "pass --device cpu to train on the CPU")
    # Multi-process scale-out is one environment variable away
    # (VAT_COORDINATOR; a no-op otherwise).
    from vision_assist_tpu_torch.parallel.distributed import (
        maybe_initialize,
        process_device,
    )
    multi = maybe_initialize(device)
    if multi:
        device = process_device(device)

    # The start (caching the dataset, building the state) must not trip the
    # stall watchdog: a generous limit until the first step completes, then
    # --watchdog-secs. One (timestamp, limit) tuple, rebound atomically.
    progress = {"mark": (time.time(), max(args.watchdog_secs, 2400))}
    stop = threading.Event()

    def watchdog():
        while not stop.wait(30):
            t, limit = progress["mark"]
            if time.time() - t > limit:
                print(f"WATCHDOG: no progress for {limit}s, aborting for "
                      "supervised restart", flush=True)
                os._exit(42)

    faulthandler.dump_traceback_later(900, repeat=True)
    threading.Thread(target=watchdog, daemon=True).start()
    try:
        return _train(args, device, progress, multi)
    finally:
        stop.set()
        faulthandler.cancel_dump_traceback_later()


def _train(args: argparse.Namespace, device: torch.device,
           progress: dict, multi: bool) -> int:
    from vision_assist_tpu_torch.data.augment import AugmentConfig
    from vision_assist_tpu_torch.data.dataset import SegDataset
    from vision_assist_tpu_torch.data.loader import BatchLoader
    from vision_assist_tpu_torch.models.checkpoint import (
        load_train_state,
        load_variables,
        save_variables,
    )
    from vision_assist_tpu_torch.models.evaluate import evaluate
    from vision_assist_tpu_torch.models.losses import LossConfig
    from vision_assist_tpu_torch.models.train import (
        TrainConfig,
        create_train_state,
        make_train_step,
    )
    from vision_assist_tpu_torch.models.yolo import (
        YoloSeg,
        convert_flax_variables,
        to_flax_variables,
    )
    from vision_assist_tpu_torch.parallel.distributed import (
        globalize_batch,
        local_loader_params,
        process_info,
    )

    # Host-side artifacts (evaluation, history.json, checkpoints, the state
    # rotation) are rank 0's work. The collapse decisions run on every rank:
    # their inputs (the step metrics, summed over the ranks, and rank 0's
    # word on the saved state) are the same everywhere.
    is_main = process_info()[0] == 0
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu", flush=True)
    # The recipe as run, for provenance (the reference ships args.yaml).
    (out / "args.json").write_text(json.dumps(
        {k: str(v) if isinstance(v, pathlib.Path) else v
         for k, v in vars(args).items()}, indent=1))

    ds = SegDataset(args.data, args.train_split,
                    cache_images=args.imgsz if args.cache_images else None)
    aug = AugmentConfig(copy_paste=args.copy_paste, degrees=args.degrees,
                        shear=args.shear, perspective=args.perspective)
    # Each process loads its own slice of the global batch from its own
    # seed; single-process, the whole batch from seed 0.
    local_bs, local_seed = local_loader_params(args.batch, seed=0)
    loader = BatchLoader(ds, batch_size=local_bs, imgsz=args.imgsz,
                         augment=True, seed=local_seed, aug=aug,
                         wire_format=args.wire_format)
    steps_per_epoch = len(ds) // args.batch          # global steps an epoch
    if steps_per_epoch == 0:
        raise SystemExit(f"--batch {args.batch} exceeds the dataset "
                         f"({len(ds)} images): zero steps per epoch")
    cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch,
                      imgsz=args.imgsz, lr0=args.lr0,
                      wire_format=args.wire_format)
    print("dataset cached; creating train state...", flush=True)
    t0 = time.time()
    torch.manual_seed(0)
    model = YoloSeg(args.arch, num_classes=1, dtype=torch.bfloat16,
                    param_dtype=torch.float32)
    if args.resume:
        # Params, EMA (a copy of the params) and batch stats from the file.
        model.load_state_dict(convert_flax_variables(load_variables(args.resume),
                                                     model))
    if multi:
        from vision_assist_tpu_torch.parallel.mesh import make_mesh
        from vision_assist_tpu_torch.parallel.train_step import create_dp_train_state
        mesh = make_mesh()
        state, collectives = create_dp_train_state(model, cfg, steps_per_epoch,
                                                   mesh, device=device)
        step = make_train_step(model, LossConfig(), cfg, collectives)
    else:
        state = create_train_state(model, cfg, steps_per_epoch, device=device)
        step = make_train_step(model, LossConfig(), cfg)
    print(f"train state ready in {time.time() - t0:.1f}s", flush=True)
    if args.resume:
        print(f"resumed params from {args.resume}", flush=True)
    if args.resume_state:
        state = load_train_state(args.resume_state, state)
        print(f"resumed full train state from {args.resume_state} "
              f"(step {state.step})", flush=True)

    history = []
    if (out / "history.json").exists():
        history = json.loads((out / "history.json").read_text())
    best_map = max((h.get("map50_mask", -1.0) for h in history), default=-1.0)
    start_epoch = state.step // steps_per_epoch
    if start_epoch:
        print(f"continuing at epoch {start_epoch + 1}", flush=True)

    for epoch in range(start_epoch, args.epochs):
        # <= not ==: a run resumed inside the closed-mosaic window builds a
        # fresh loader (mosaic on) at an epoch where == never fires again.
        if args.epochs - epoch <= args.close_mosaic and loader.mosaic_enabled:
            loader.mosaic_enabled = False
            print("mosaic closed", flush=True)

        t0 = time.time()
        losses, wait = [], 0.0
        batches = loader.epoch(workers=args.workers)
        for si in range(steps_per_epoch):
            w0 = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - w0
            if batch is None:
                break
            if multi:
                batch = globalize_batch(batch, mesh)
            state, metrics = step(state, batch)
            losses.append(metrics)
            if (si + 1) % args.sync_every == 0:
                metrics["loss"].item()
                progress["mark"] = (time.time(), args.watchdog_secs)
        batches.close()
        # One fetch an epoch: every metric of every step in one copy.
        keys = list(losses[0])
        fetched = torch.stack([torch.stack([m[k].float() for k in keys])
                               for m in losses]).cpu().numpy()
        progress["mark"] = (time.time(), args.watchdog_secs)
        mean = {k: float(np.mean(fetched[:, j])) for j, k in enumerate(keys)}
        dt = time.time() - t0
        print(f"epoch {epoch + 1}/{args.epochs} "
              f"loss={mean['loss']:.3f} box={mean['box']:.3f} "
              f"seg={mean['seg']:.3f} cls={mean['cls']:.3f} "
              f"dfl={mean['dfl']:.3f} [{dt:.1f}s, "
              f"{steps_per_epoch * args.batch / dt:.1f} img/s, "
              f"loader wait {wait:.3f}s]", flush=True)
        record = {"epoch": epoch + 1, **mean, "time_s": dt}

        is_last = epoch + 1 == args.epochs
        ema_vars = (to_flax_variables(model, state.eval_state_dict(model))
                    if is_main else None)
        if is_main and ((epoch + 1) % args.eval_every == 0 or is_last):
            progress["mark"] = (time.time(), max(args.watchdog_secs, 2400))
            m = evaluate(model, ema_vars, args.data, "valid", imgsz=args.imgsz,
                         max_images=None if is_last else args.eval_images,
                         device=device)
            progress["mark"] = (time.time(), args.watchdog_secs)
            print(f"  val: mAP50(M)={m['map50_mask']:.4f} "
                  f"mAP50-95(M)={m['map50_95_mask']:.4f} "
                  f"mAP50(B)={m['map50_box']:.4f}", flush=True)
            record.update(m)
            if m["map50_mask"] > best_map:
                best_map = m["map50_mask"]
                save_variables(out / "best.msgpack", ema_vars)

        # Collapse guard: training can blow up (one bad step at a high rate)
        # into the self-reinforcing "predict nothing" state. On its
        # signature, revert to the previous saved state; the loader's stream
        # has moved on, so the retried epochs see fresh batches.
        state_avail = (out / "state").exists()
        if multi:
            # Only rank 0 writes out/state: its word decides, so that the
            # ranks revert together.
            word = [state_avail]
            torch.distributed.broadcast_object_list(word, src=0)
            state_avail = word[0]
        collapsed, med_loss, med_fg = collapse_decision(history, mean, state_avail)
        if collapsed:
            print(f"COLLAPSE at epoch {epoch + 1}: loss {mean['loss']:.1f} "
                  f"(median {med_loss:.1f}), fg/img {mean['fg_per_img']:.2f} "
                  f"(median {med_fg:.2f}); reverting to the previous epoch's "
                  "state", flush=True)
            record["reverted"] = True
            history.append(record)
            if is_main:
                _write_history(out, history)
            if not (out / "state").exists():
                # Every rank must read the checkpoint rank 0 wrote.
                raise RuntimeError(
                    "collapse-revert in multi-process mode requires --out "
                    f"({out}) on a filesystem shared by all processes; "
                    f"out/state is missing on rank {process_info()[0]}")
            state = load_train_state(out / "state", state)
            continue

        history.append(record)
        if is_main:
            _write_history(out, history)
            if args.save_state_every and (epoch + 1) % args.save_state_every == 0:
                _rotate_state(out, state)
            save_variables(out / "last.msgpack", ema_vars)
        rss_gb = _rss_gb()
        print(f"  host rss: {rss_gb:.1f} GB", flush=True)
        if rss_gb > args.max_rss_gb:
            print(f"RSS {rss_gb:.1f} GB > --max-rss-gb {args.max_rss_gb}; "
                  "restarting for memory hygiene", flush=True)
            return 42
    return 0


if __name__ == "__main__":
    sys.exit(main())
