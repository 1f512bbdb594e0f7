"""Cycles the NMS kernel spends in each of its sections, and its device time.

``csrc/nms.cu`` marks its sections with ``// @profile`` comments. This script
builds a copy of the source with a ``clock64()`` stamp at each marker, taken
by thread 0 of an image's leader CTA as it passes (in-kernel clocks need no
profiler on the card), and prints them for the first and the last image of a
launch, with the ``%globaltimer`` nanosecond at which each of the two leaders
started and ended: two images that start far apart ran in different waves.
The inputs are ``chip_smoke.py``'s seeded ones, shaped like its phase ``nms``:
served (A = 1344 anchors, 9 valid an image, K = 256, 1 and 8 images), an
evaluation batch (A = 1344, 36 valid an image, K = 1024, 16 images) and dense
inputs (97 % valid; A = K = 1024 and A = 8400, K = 1024; 1, 8 and 16 images).
Beside each, the unstamped kernel's device time (launches queued behind a
sleep, CUDA events). The stamps keep the compiler from moving work across
them, so the sections sum to an upper estimate of the unstamped kernel's.
The stamped copy is loaded in place of the kernel for this process only.

    python -m vision_assist_tpu_torch.utils.profile_nms      (from the repository root)
"""

from __future__ import annotations

import re
import sys

import torch

from vision_assist_tpu_torch.ops import cuda_nms
from vision_assist_tpu_torch.tools._card import cuda_ms
from vision_assist_tpu_torch.utils.build import BUILD_DIR

SERVED = (0.5, 0.7, 256, 32)
EVAL = (0.001, 0.7, 1024, 300)
# name, images, anchors, valid anchors an image (None: 97 %), settings
CASES = (("served", 1, 1344, 9, SERVED), ("served", 8, 1344, 9, SERVED),
         ("eval", 16, 1344, 36, EVAL),
         ("dense", 1, 1024, None, EVAL), ("dense", 8, 1024, None, EVAL),
         ("dense", 16, 1024, None, EVAL), ("dense", 16, 8400, None, EVAL))


def instrumented_source() -> tuple[str, list[str]]:
    """The kernel's source with its markers turned into clock stamps, and
    the sections' names."""
    src = cuda_nms.SOURCE.read_text()
    names: list[str] = []

    def stamp(match: re.Match) -> str:
        names.append(match.group(3))
        return (f"{match.group(1)}if (tid == 0) {{ const long long now_ = clock64(); "
                f"prof_[{match.group(2)}] = now_ - last_; last_ = now_; }}")

    src = re.sub(r"( *)// @profile stamp (\d+) (.*)", stamp, src)
    n = len(names)
    report = (
        "__syncthreads();\n"
        "  if (tid == 0 && (image == 0 || image == gridDim.x / kCluster - 1)) {\n"
        "    const long long now_ = clock64();\n"
        "    unsigned long long end_;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(end_));\n"
        "    printf(\"  image %d: n %d, start %llu ns, end %llu ns, cycles:"
        + " %lld" * (n + 1) + "\\n\", image, n, start_, end_, "
        + "".join(f"prof_[{j}], " for j in range(n)) + "now_ - last_);\n"
        "  }")
    declare = (f"long long prof_[{n}] = {{}}; long long last_ = clock64(); "
               "unsigned long long start_; "
               "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(start_));")
    for marker, code in (("// @profile include", "#include <cstdio>"),
                         ("// @profile declare", declare),
                         ("// @profile report", report)):
        if src.count(marker) != 1:
            raise RuntimeError(f"{cuda_nms.SOURCE}: marker {marker!r} not found once")
        src = src.replace(marker, code)
    return src, names + ["outputs"]


def main(argv: list[str]) -> int:
    if argv or not torch.cuda.is_available():
        print("profile_nms: takes no arguments and needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import seeded_nms_inputs

    dev = torch.device("cuda")
    inputs = [(f"{name} A={a} K={kw[2]} S={s}",
               seeded_nms_inputs(torch, s, a, valid, kw[0], i, dev), kw)
              for i, (name, s, a, valid, kw) in enumerate(CASES)]
    for label, args, kw in inputs:      # the unstamped kernel first
        ms = cuda_ms(lambda: cuda_nms.nms_cuda(*args, *kw), reps=100, queued=True)
        print(f"{label}: {ms:.5f} ms on the device (queued CUDA events)", flush=True)
    src, names = instrumented_source()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "nms_profile.cu"
    path.write_text(src)
    source, lib = cuda_nms.SOURCE, cuda_nms._lib
    cuda_nms.SOURCE, cuda_nms._lib = path, None
    try:
        print("sections: " + "; ".join(f"{i} {n}" for i, n in enumerate(names)))
        for label, args, kw in inputs:
            print(f"{label}, stamped, a first launch and a second:", flush=True)
            for _ in range(2):
                cuda_nms.nms_cuda(*args, *kw)
                torch.cuda.synchronize()        # the kernel's printf comes out here
    finally:
        cuda_nms.SOURCE, cuda_nms._lib = source, lib
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
