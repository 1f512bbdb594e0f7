"""How many of the port bench's frames give at least one detection: the
served bf16 model on the card against the float32 model on the CPU.

    python -m vision_assist_tpu_torch.tools.diagnose_detections [--frames 30]

The port of the JAX package's tools/diagnose_detections.py. The frames are
the port bench's (vision_assist_tpu_torch/bench.py ``load_frames``: the demo
PNGs topped up with seeded walkways); the served configuration (640x640 as
I420, the flagship weights, engine "exact") runs them through
``FrameProcessor.__call__`` once on ``--device`` with the flagship's bf16
compute, and once on the CPU in float32. Prints one JSON object: both
counts, and the frames that have a detection in one run and none in the
other.
"""

from __future__ import annotations

import sys

import torch

from vision_assist_tpu_torch.tools import _card


def _run(device: torch.device, dtype: str | None, frames) -> tuple[list[int], list[str]]:
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    fp = FrameProcessor(_card.served_config("exact"),
                        segmenter=_card.flagship_segmenter(device, dtype=dtype),
                        device=device)
    counts, answers = [], []
    for i, frame in enumerate(frames):
        res = fp(frame, now_ms=1000 + i * 33)
        counts.append(res.n_detections)
        answers.append(res.final_answer)
    return counts, answers


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    dev = _card.require(args.device)
    frames = _card.bench_frames(args.frames)
    served, served_answers = _run(dev, None, frames)
    cpu, cpu_answers = _run(torch.device("cpu"), "float32", frames)
    n = len(frames)
    return _card.finish({
        "tool": "diagnose_detections", "frames": n,
        "served_bf16": {"frames_with_detections": f"{sum(c > 0 for c in served)}/{n}",
                        "answers_nonempty": sum(bool(a) for a in served_answers)},
        "cpu_float32": {"frames_with_detections": f"{sum(c > 0 for c in cpu)}/{n}",
                        "answers_nonempty": sum(bool(a) for a in cpu_answers)},
        "frames_differing": [i for i in range(n) if (served[i] > 0) != (cpu[i] > 0)],
        **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
