"""Cycles the fast-sweeping kernel spends in each of its sections, and its
device time.

``csrc/relax_sweep.cu`` marks its sections with ``// @profile`` comments: the
field and ``h`` loads with the one-step shift, the doubling levels, the store
and the need flags, the barrier wait, and the launch's setup before the first
pass. This script builds a copy of the source with
a ``clock64()`` stamp at each marker, taken by lane 0 of one warp of every
CTA (warp 0 unless ``--warp`` names another: the scans of that warp's lines
and its waits at the barriers),
summed over the launch, and prints them per pass for every CTA of the first
and the last stream of a launch, with the ``%globaltimer`` nanosecond at
which each CTA started and ended. In-kernel clocks need no profiler on the
card. The stamps keep the compiler from moving work across them, so the
sections sum to an upper estimate of the unstamped kernel's. The stamped copy
is loaded in place of the kernel for this process only.

The inputs are ``chip_smoke.py``'s six of phase ``sweep`` (the served 32x32
lattice alone and the 8 of them, the 13 scenarios and seeded 64x36 lattices
at B=13, the 1080p corridor and a seeded 54x96 lattice); beside each, the
unstamped kernel's device time (launches queued behind a sleep, CUDA events).

    python -m vision_assist_tpu_torch.utils.profile_sweep      (from the repository root)
    python -m vision_assist_tpu_torch.utils.profile_sweep --cluster 2 --warp 31

``--cluster K`` launches K CTAs a stream where the lattice allows it (0, the
default, takes the launch's own choice); ``--warp W`` takes the stamps in
warp W (a busier one than warp 0 shows where a half pass goes).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import pathlib
import re
import sys
import tempfile

import torch

from vision_assist_tpu_torch.ops import cuda_sweep
from vision_assist_tpu_torch.utils.build import BUILD_DIR, compile_shared, nvcc

_LINE = re.compile(r"sweep-profile stream (\d+) rank (\d+) passes (\d+) "
                   r"start (\d+) end (\d+) cycles((?: -?\d+)+)")


def instrumented_source(src: str, warp: int = 0) -> tuple[str, list[str]]:
    """``src`` with its markers turned into clock stamps, taken by lane 0 of
    warp ``warp`` (of the last warp where a CTA has fewer), and the
    sections' names in stamp order. A stamp adds the cycles since the last
    one to its section; one section may be stamped at several places."""
    names: dict[int, str] = {}
    me = f"(threadIdx.x == min({32 * warp}u, blockDim.x - 32u))"

    def stamp(match: re.Match) -> str:
        k, name = int(match.group(2)), match.group(3).strip()
        if names.setdefault(k, name) != name:
            raise RuntimeError(f"profile stamp {k} names {names[k]!r} and {name!r}")
        return (f"{match.group(1)}if {me} {{ const long long now_ = clock64(); "
                f"prof_[{k}] += now_ - prof_last_; prof_last_ = now_; }}")

    src = re.sub(r"( *)// @profile stamp (\d+) (.*)", stamp, src)
    if sorted(names) != list(range(len(names))):
        raise RuntimeError(f"profile stamps {sorted(names)} are not 0..{len(names) - 1}")
    n = len(names)
    include = ("#include <cstdio>\n"
               f"__shared__ long long prof_[{n}];\n"
               "__shared__ long long prof_last_;\n"
               "__shared__ unsigned long long prof_start_;")
    declare = (f"if {me} {{\n"
               f"    for (int i_ = 0; i_ < {n}; ++i_) prof_[i_] = 0;\n"
               "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(prof_start_));\n"
               "    prof_last_ = clock64();\n"
               "  }")

    def report(match: re.Match) -> str:
        stream, rank, cluster, passes = (x.strip() for x in match.group(2).split(","))
        return (
            f"{match.group(1)}if ({me} && ({stream} == 0 || "
            f"{stream} == gridDim.x / ({cluster}) - 1)) {{\n"
            "    unsigned long long end_;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(end_));\n"
            "    printf(\"sweep-profile stream %d rank %d passes %d start %llu end %llu cycles"
            + " %lld" * n + "\\n\", " + f"{stream}, {rank}, {passes}, prof_start_, end_"
            + "".join(f", prof_[{j}]" for j in range(n)) + ");\n"
            f"{match.group(1)}}}")

    for marker, code in (("// @profile include", include), ("// @profile declare", declare)):
        if src.count(marker) != 1:
            raise RuntimeError(f"marker {marker!r} not found once")
        src = src.replace(marker, code)
    src, found = re.subn(r"( *)// @profile report\((.*)\)", report, src)
    if found != 1:
        raise RuntimeError("marker '// @profile report(stream, rank, cluster, passes)' "
                           "not found once")
    return src, [names[k] for k in range(n)]


def parse(text: str, names: list[str]) -> list[dict]:
    """The stamped kernel's printed lines as records: stream, rank, passes,
    the CTA's nanoseconds from start to end, and the cycles of each section
    summed over the launch and per pass."""
    out = []
    for m in _LINE.finditer(text):
        stream, rank, passes, start, end = (int(m.group(i)) for i in range(1, 6))
        cycles = [int(x) for x in m.group(6).split()]
        if len(cycles) != len(names):
            raise RuntimeError(f"{len(cycles)} sections printed, {len(names)} stamped")
        out.append({"stream": stream, "rank": rank, "passes": passes, "start_ns": start,
                    "end_ns": end, "ns": end - start, "cycles": dict(zip(names, cycles)),
                    "per_pass": {k: c / max(passes, 1) for k, c in zip(names, cycles)}})
    return out


@contextlib.contextmanager
def _stdout_to(path: pathlib.Path):
    """File descriptor 1 (where the kernel's printf goes) into ``path``;
    the C library's buffers are flushed on both sides of the switch."""
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        libc.fflush(None)
        os.dup2(saved, 1)
        os.close(saved)


def stamped_source(warp: int = 0) -> tuple[pathlib.Path, list[str]]:
    """The stamped copy of the kernel's source, stamped by ``warp``, written
    into the build directory, and the sections' names."""
    src, names = instrumented_source(cuda_sweep.SOURCE.read_text(), warp)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"relax_sweep_profile_w{warp}.cu"
    path.write_text(src)
    return path, names


def prebuild(warp: int = 0) -> None:
    """Compile the stamped copy ahead of ``stamped_runs``, which then loads
    it from the build directory (to overlap its compilation with others)."""
    path, _ = stamped_source(warp)
    compile_shared(nvcc(), cuda_sweep.NVCC_FLAGS, path, "relax_sweep")


def stamped_runs(inputs: dict, turn: torch.Tensor, cluster: int = 0, warp: int = 0
                 ) -> tuple[list[str], dict]:
    """Build the stamped copy of the kernel, stamped by ``warp`` (or load it
    where ``prebuild`` made it), launch it once on each of ``inputs`` (name
    -> (enter, start)) in clusters of ``cluster`` CTAs (0: the launch's
    choice), and return the sections' names and each input's records. The
    kernel's library is restored afterwards."""
    path, names = stamped_source(warp)
    kept = ("SOURCE", "_lib", "launches", "build_log", "build_seconds", "compiled")
    saved = [getattr(cuda_sweep, name) for name in kept]
    by_form = dict(cuda_sweep.launches_by_form)
    cuda_sweep.SOURCE, cuda_sweep._lib = path, None
    records = {}
    try:
        for name, (enter, start) in inputs.items():
            with tempfile.TemporaryDirectory() as tmp:
                log = pathlib.Path(tmp) / "printf.txt"
                with _stdout_to(log):
                    cuda_sweep.relax_sweep_field_cuda(enter, start, turn, cluster=cluster)
                    torch.cuda.synchronize()    # the kernel's printf comes out here
                records[name] = parse(log.read_text(), names)
    finally:
        for name, value in zip(kept, saved):
            setattr(cuda_sweep, name, value)
        cuda_sweep.launches_by_form.update(by_form)
    return names, records


def summary(name: str, names: list[str], recs: list[dict]) -> list[str]:
    """One line an input for the CTAs of its first stream: cycles a pass in
    each section (the mean over those CTAs; the launch's setup, before the
    first pass, whole) and their span of time; one line for the last stream
    when it is another."""
    lines = []
    for stream in sorted({r["stream"] for r in recs}):
        mine = [r for r in recs if r["stream"] == stream]
        per = {k: sum(r["per_pass"][k] for r in mine) / len(mine)
               for k in names if k != "setup"}
        setup = [r["cycles"]["setup"] for r in mine if "setup" in r["cycles"]]
        start = min(r["start_ns"] for r in mine)
        lines.append(
            f"{name} stream {stream}: {len(mine)} CTA(s), passes {mine[0]['passes']}, "
            f"cycles a pass " + ", ".join(f"{k} {v:.0f}" for k, v in per.items())
            + f", total {sum(per.values()):.0f}"
            + (f"; setup {sum(setup) / len(setup):.0f} cycles once" if setup else "")
            + "; CTAs (rank: start-end ns from the first start) "
            + ", ".join(f"{r['rank']}: {r['start_ns'] - start}-{r['end_ns'] - start}"
                        for r in sorted(mine, key=lambda r: r["rank"])))
    return lines


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", type=int, default=0,
                    help="CTAs a stream (0: the launch's own choice)")
    ap.add_argument("--warp", type=int, default=0,
                    help="the warp whose lane 0 takes the stamps (default 0)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import sweep_inputs

    from vision_assist_tpu_torch.config import PathFinderConfig
    from vision_assist_tpu_torch.planning.wavefront import _scaled_turn
    from vision_assist_tpu_torch.tools._card import cuda_ms

    dev = torch.device("cuda")
    turn = _scaled_turn(20, PathFinderConfig().wavefront_turn_weight, 30.0, 1.5, 90.0, dev)
    inputs, _ = sweep_inputs(torch, dev)
    if args.cluster:
        for name in [n for n, (e, _) in inputs.items()
                     if not cuda_sweep.takes(*e.shape[1:], args.cluster)]:
            print(f"{name}: not taken in clusters of {args.cluster}")
            del inputs[name]
    for name, (enter, start) in inputs.items():      # the unstamped kernel first
        ms = cuda_ms(lambda: cuda_sweep.relax_sweep_field_cuda(
            enter, start, turn, cluster=args.cluster), reps=100, queued=True)
        print(f"{name}: {ms:.5f} ms on the device (queued CUDA events)", flush=True)
    names, records = stamped_runs(inputs, turn, args.cluster, args.warp)
    print("sections: " + "; ".join(f"{i} {n}" for i, n in enumerate(names)))
    for name, recs in records.items():
        for line in summary(name, names, recs):
            print(line, flush=True)
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
