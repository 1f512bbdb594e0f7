"""Where a served frame's wall time goes on the host, inside the real loops.

    python -m vision_assist_tpu_torch.tools.diagnose_host_breakdown \
        [--frames 60] [--depth 8] [--steps 12] [--batch-depth 2] [--engine exact]

The port of the JAX package's tools/diagnose_host_breakdown.py. It times the
stages of the single-stream loop at depth 8 (FrameProcessor.submit_frame /
retire_frame, as StreamingServer drives them) and of 8 streams a step at
depth 2 (MultiStreamProcessor.submit_frames / retire_frames), each stage
bracketed with perf_counter inside the loop, so the stages sum to the loop's
wall time by construction. The submit half is FrameProcessor._run_program
split into its parts:

  pack      the host's BGR -> I420 packer (FrameProcessor._pack_frame)
  pin       the packed frame copied into pinned host memory
  put       the upload to the card, issued (non-blocking)
  dispatch  the device program's call: every launch of the frame issued
  hostcopy  the payload's copy into pinned memory and its event, issued
  wait      the oldest payload's event waited for
  unpack    the payload read into its fields
  plan      the host half's planning (peaks, A* for "exact", sections, dedup)
  analyse   the instruction engine and the result

It answers why depth-N serving runs no faster than the synchronous loop:
what share of a frame the host spends issuing the program (dispatch) against
waiting for the card (wait). Prints one JSON object; host times only.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from vision_assist_tpu_torch.tools import _card

STAGES = ("pack", "pin", "put", "dispatch", "hostcopy", "wait", "unpack",
          "plan", "analyse")


def _submit(fp, packed: np.ndarray, cache, t: dict):
    """FrameProcessor._run_program, stage by stage: (handle, next cache)."""
    from vision_assist_tpu_torch.pipeline.frame_processor import _Handle

    cuda = fp.device.type == "cuda"
    t0 = time.perf_counter()
    src = torch.from_numpy(np.ascontiguousarray(packed))
    if cuda:
        src = src.pin_memory()
    t1 = time.perf_counter()
    dev_frames = src.to(fp.device, non_blocking=cuda)
    t2 = time.perf_counter()
    if cache is not None:
        payload, cache = fp._device_fn(dev_frames, cache)
    else:
        payload = fp._device_fn(dev_frames)
    t3 = time.perf_counter()
    if cuda:
        host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        handle = _Handle(host=host, done=done)
    else:
        handle = _Handle(host=payload, done=None)
    t4 = time.perf_counter()
    for name, a, b in (("pin", t0, t1), ("put", t1, t2), ("dispatch", t2, t3),
                       ("hostcopy", t3, t4)):
        t[name] += b - a
    return handle, cache


def _summary(t: dict, wall: float, n_units: int, n_frames: int) -> dict:
    out = {f"{k}_host_ms": t[k] / n_units * 1e3 for k in STAGES}
    total = sum(t[k] for k in STAGES)
    out["stage_sum_host_ms"] = total / n_units * 1e3
    out["wall_host_ms"] = wall / n_units * 1e3
    out["shares"] = {k: t[k] / wall for k in STAGES}
    out["frames_per_s"] = n_frames / wall
    return out


def single_stream(fp, frames: np.ndarray, n: int, depth: int) -> dict:
    """The depth-``depth`` loop of one stream; ms a frame."""
    t = collections.defaultdict(float)
    inflight: collections.deque = collections.deque()

    def retire(now_ms):
        t0 = time.perf_counter()
        buf = inflight.popleft().payload()
        t1 = time.perf_counter()
        payload = fp._unpack(buf)
        t2 = time.perf_counter()
        guidance = fp._guidance(payload)
        t3 = time.perf_counter()
        fp._result(payload, guidance, fp.analyser, now_ms)
        t4 = time.perf_counter()
        for name, a, b in (("wait", t0, t1), ("unpack", t1, t2),
                           ("plan", t2, t3), ("analyse", t3, t4)):
            t[name] += b - a

    wall0 = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        packed = fp._pack_frame(frames[i % len(frames)])
        t["pack"] += time.perf_counter() - t0
        handle, fp._astar_cache = _submit(fp, packed, fp._astar_cache, t)
        inflight.append(handle)
        if len(inflight) >= depth:
            retire(1000 + i * 33)
    while inflight:
        retire(9999)
    wall = time.perf_counter() - wall0
    out = _summary(t, wall, n, n)
    out.update(frames=n, depth=depth)
    return out


def batched(msp, frames: np.ndarray, steps: int, depth: int) -> dict:
    """The depth-``depth`` loop of S streams a step; ms a step."""
    t = collections.defaultdict(float)
    fp, s = msp._fp, msp.num_streams
    step_frames = frames[:s]
    inflight: collections.deque = collections.deque()

    def retire(now_ms):
        t0 = time.perf_counter()
        rows = inflight.popleft().payload()
        t1 = time.perf_counter()
        payloads = [fp._unpack(row) for row in rows]
        t2 = time.perf_counter()
        guided = msp._per_stream(lambda k, engine: fp._guidance(payloads[k], engine))
        t3 = time.perf_counter()
        for k in range(s):
            fp._result(payloads[k], guided[k], msp.analysers[k], now_ms)
        t4 = time.perf_counter()
        for name, a, b in (("wait", t0, t1), ("unpack", t1, t2),
                           ("plan", t2, t3), ("analyse", t3, t4)):
            t[name] += b - a

    wall0 = time.perf_counter()
    for rep in range(steps):
        t0 = time.perf_counter()
        packed = np.stack([fp._pack_frame(f) for f in step_frames])
        t["pack"] += time.perf_counter() - t0
        handle, msp._caches[0] = _submit(fp, packed, msp._caches[0], t)
        inflight.append(handle)
        if len(inflight) >= depth:
            retire(7000 + rep * 33)
    while inflight:
        retire(9999)
    wall = time.perf_counter() - wall0
    out = _summary(t, wall, steps, steps * s)
    out.update(steps=steps, streams=s, depth=depth)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--engine", default="exact",
                    choices=("exact", "exact_device", "wavefront"))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch-depth", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    dev = _card.require(args.device)

    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

    seg = _card.flagship_segmenter(dev)
    frames = _card.bench_frames(max(args.streams, min(args.frames, 30)))
    fp = FrameProcessor(_card.served_config(args.engine), segmenter=seg, device=dev)
    for i in range(args.warmup):
        fp(frames[i % len(frames)], now_ms=i * 33)
    single = single_stream(fp, frames, args.frames, args.depth)
    msp = MultiStreamProcessor(_card.served_config(args.engine, args.streams),
                               segmenter=seg, device=dev)
    try:
        msp.process_frames(frames[:args.streams], now_ms=0)
        multi = batched(msp, frames, args.steps, args.batch_depth)
    finally:
        msp.close()
    return _card.finish({
        "tool": "diagnose_host_breakdown", "engine": args.engine,
        "single_stream": single, "batched": multi, **_card.card_stamp(dev),
    }, args.out)


if __name__ == "__main__":
    sys.exit(main())
