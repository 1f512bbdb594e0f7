"""The device program alone: its upload, synchronous against pipelined
calls, fed resident frames against numpy, and S streams a call.

    python -m vision_assist_tpu_torch.tools.diagnose_fused [--reps 15] [--depth 8]

The port of the JAX package's tools/diagnose_fused.py. On the served
configuration (engine "exact", flagship weights, one 640x640 frame as I420):

* the upload of the frame's planes: a blocking copy (host ms) and the copy
  on the card (device ms);
* the program (pipeline/frame_program.py) on a resident frame, each call
  waiting for the card (host ms), against ``--depth`` calls issued before
  one wait (host ms a call), and its device time (CUDA events);
* the same pipelined calls fed the numpy frame (an upload a call);
* the payload's copy back to the host (host ms);
* S = 4 and 8 streams a call: synchronous and pipelined, ms a frame.

Prints one JSON object.
"""

from __future__ import annotations

import sys

import torch

from vision_assist_tpu_torch.tools import _card


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--streams", type=int, nargs="+", default=[4, 8])
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    dev = _card.require(args.device)

    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    fp = FrameProcessor(_card.served_config("exact"),
                        segmenter=_card.flagship_segmenter(dev), device=dev)
    fp._ensure_program()
    fn = fp._device_fn
    frame = _card.bench_frames(1)[0]
    plane_np = bgr_to_i420_host(frame)
    plane_host = torch.from_numpy(plane_np)
    plane = plane_host.to(dev)
    reps, depth = args.reps, args.depth

    def piped(get_frame):
        def run():
            for _ in range(depth):
                fn(get_frame())
            _card.sync(dev)
        return _card.host_ms(run, max(1, reps // depth)) / depth

    out: dict = {"tool": "diagnose_fused", "depth": depth}
    out["h2d_blocking_host_ms"] = _card.sync_ms(lambda: plane_host.to(dev), reps, dev)
    out["h2d_copy_device_ms"] = _card.device_ms(lambda: plane_host.to(dev), reps, dev)
    out["program_sync_host_ms"] = _card.sync_ms(lambda: fn(plane), reps, dev)
    out["program_pipelined_host_ms"] = piped(lambda: plane)
    out["program_device_ms"] = _card.device_ms(lambda: fn(plane), reps, dev)
    out["program_numpy_pipelined_host_ms"] = piped(
        lambda: torch.from_numpy(plane_np).to(dev))
    payload = fn(plane)
    out["d2h_payload_host_ms"] = _card.host_ms(lambda: payload.cpu(), reps)
    out["payload_bytes"] = payload.numel() * payload.element_size()
    for s in args.streams:
        planes = plane[None].repeat(s, 1, 1).contiguous()
        out[f"streams{s}_sync_host_ms_per_frame"] = _card.sync_ms(
            lambda: fn(planes), max(1, reps // 2), dev) / s
        out[f"streams{s}_pipelined_host_ms_per_frame"] = piped(lambda: planes) / s
    return _card.finish({**out, **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
