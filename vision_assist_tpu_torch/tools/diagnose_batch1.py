"""Bisect the device program by stage, at one and at two streams a call.

    python -m vision_assist_tpu_torch.tools.diagnose_batch1 [--reps 10] [--trace-dir DIR]

The port of the JAX package's tools/diagnose_batch1.py. The stages are the
program's own (pipeline/frame_program.py), each built on the one before:

  seg       I420 -> BGR and the segmenter chain (letterbox, YoloSeg, decode,
            NMS, masks, occupancy)
  blur      + the blur metric
  plan      + the plan step (lattice, penalty, peaks; paths for the wavefront
            and exact_device engines)
  program   the whole program with its packed payload

each at S = 1 and S = 2 streams a call (the JAX tool's rank probe: does one
call of two frames cost less than two calls of one?): synchronous host ms,
pipelined host ms (8 calls before one wait) and device ms (CUDA events).
With ``--trace-dir`` it writes a ``torch.profiler`` Chrome trace of one
synchronous call of the whole program there, through utils/profiling.py's
``device_trace``, and reports the device operations it holds. Prints one
JSON object.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from vision_assist_tpu_torch.tools import _card


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--engine", default="exact",
                    choices=("exact", "exact_device", "wavefront"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--trace-dir", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    _card.check_out(args.trace_dir)
    dev = _card.require(args.device)

    from vision_assist_tpu_torch.ops.blur import laplacian_variance
    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host, i420_to_bgr
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.planner import make_plan_step
    from vision_assist_tpu_torch.planning.device_astar import empty_cache

    cfg = _card.served_config(args.engine)
    seg = _card.flagship_segmenter(dev)
    fp = FrameProcessor(cfg, segmenter=seg, device=dev)
    fp._ensure_program()
    plan = make_plan_step(cfg, include_paths=args.engine != "exact")
    exact_device = args.engine == "exact_device"
    frames = _card.bench_frames(2)
    h, w = cfg.frame_height, cfg.frame_width

    def stages(planes, cache):
        def seg_stage():
            bgr = i420_to_bgr(planes, h, w)
            return bgr, seg._frame_chain(bgr)

        def blur_stage():
            bgr, out = seg_stage()
            return bgr, out, laplacian_variance(bgr)

        def plan_stage():
            _, out, blur = blur_stage()
            return plan(out.occupancy, cache), blur

        def program():
            return fp._device_fn(planes, cache) if exact_device else fp._device_fn(planes)
        return {"seg": seg_stage, "blur": blur_stage, "plan": plan_stage,
                "program": program}

    out: dict = {"tool": "diagnose_batch1", "engine": args.engine,
                 "depth": args.depth}
    for s in (1, 2):
        planes = torch.from_numpy(
            np.stack([bgr_to_i420_host(f) for f in frames[:s]])).to(dev)
        cache = empty_cache(dev).repeat(s, 1) if exact_device else None
        for name, fn in stages(planes, cache).items():
            def piped(fn=fn):
                for _ in range(args.depth):
                    fn()
                _card.sync(dev)
            out[f"{name}_s{s}"] = {
                "sync_host_ms": _card.sync_ms(fn, args.reps, dev),
                "pipelined_host_ms": _card.host_ms(
                    piped, max(1, args.reps // args.depth)) / args.depth,
                "device_ms": _card.device_ms(fn, args.reps, dev),
            }
    if args.trace_dir is not None:
        from vision_assist_tpu_torch.utils.profiling import device_trace

        one = stages(planes[:1], None if cache is None else cache[:1])["program"]
        with device_trace(args.trace_dir, device=str(dev)) as prof:
            one()
            _card.sync(dev)
        on_device = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        out["trace"] = {"path": str(args.trace_dir / "trace.json"),
                        "device_operations": len(on_device),
                        "device_busy_ms": sum(e.time_range.elapsed_us()
                                              for e in on_device) / 1e3}
    return _card.finish({**out, **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
