"""Serving latency and throughput of the three engines on one card.

    python -m vision_assist_tpu_torch.tools.diagnose_engines [--sync 20] [--pipe 40] [--steps 10]

The port of the JAX package's tools/diagnose_engines.py. For each engine
(``exact``: the host's C++ A*; ``exact_device``: the A* kernel;
``wavefront``: the relax kernel), on the served configuration with the
flagship weights and the port bench's frames:

* ``FrameProcessor.__call__`` synchronously: p50/p90 host ms a frame;
* ``submit_frame``/``retire_frame`` at depth 4: host ms a frame;
* 8 streams a step through ``MultiStreamProcessor.process_frames``: host ms
  a frame.

Host times only (each number waits for the card's payload). Prints one JSON
object.
"""

from __future__ import annotations

import sys
import time

from vision_assist_tpu_torch.tools import _card

ENGINES = ("exact", "exact_device", "wavefront")


def measure(engine: str, seg, frames, n_sync: int, n_pipe: int, depth: int,
            streams: int, steps: int, device) -> dict:
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

    fp = FrameProcessor(_card.served_config(engine), segmenter=seg, device=device)
    t0 = time.perf_counter()
    fp(frames[0], now_ms=0)
    first = time.perf_counter() - t0
    fp(frames[1 % len(frames)], now_ms=33)
    lat = []
    for i in range(n_sync):
        t0 = time.perf_counter()
        fp(frames[i % len(frames)], now_ms=1000 + i * 33)
        lat.append((time.perf_counter() - t0) * 1e3)
    handles = []
    t0 = time.perf_counter()
    for i in range(n_pipe):
        handles.append(fp.submit_frame(frames[i % len(frames)]))
        if len(handles) >= depth:
            fp.retire_frame(handles.pop(0), now_ms=3000 + i * 33)
    while handles:
        fp.retire_frame(handles.pop(0), now_ms=6000)
    pipelined = (time.perf_counter() - t0) * 1e3 / n_pipe
    msp = MultiStreamProcessor(_card.served_config(engine, streams),
                               segmenter=seg, device=device)
    try:
        step = frames[:streams]
        msp.process_frames(step, now_ms=0)
        t0 = time.perf_counter()
        for rep in range(steps):
            msp.process_frames(step, now_ms=7000 + rep * 33)
        batched = (time.perf_counter() - t0) * 1e3 / (steps * streams)
    finally:
        msp.close()
    return {"first_call_host_s": first,
            "sync_host_ms": _card.percentiles(lat, (50, 90)),
            f"depth{depth}_host_ms_per_frame": pipelined,
            f"streams{streams}_host_ms_per_frame": batched}


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--sync", type=int, default=20)
    ap.add_argument("--pipe", type=int, default=40)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    dev = _card.require(args.device)
    seg = _card.flagship_segmenter(dev)
    frames = _card.bench_frames(max(16, args.streams))
    engines = {e: measure(e, seg, frames, args.sync, args.pipe, args.depth,
                          args.streams, args.steps, dev) for e in ENGINES}
    return _card.finish({"tool": "diagnose_engines", "engines": engines,
                         **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
