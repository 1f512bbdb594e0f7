"""Fast-sweeping wavefront relaxation as a hand-written CUDA kernel for Hopper
(sm_90a).

Counterpart of the compiled JAX device loop
``vision_assist_tpu/planning/wavefront.py::relax_sweep`` (a
``lax.while_loop`` of passes, each four ``lax.associative_scan``s), the
relaxation of the default wavefront flags: all passes of B streams in one
launch, a thread-block cluster of k CTAs a stream, each CTA with a replica of
the field and the doubling scan's levels of its own lines (level 0 the entry
costs) in shared memory, each warp the owner of at most one row and one
column for the whole launch (see ``csrc/relax_sweep.cu`` for the design and
what bounds it). ``cluster_size`` picks k from the lattice. The field is bit-equal to the plain twin
``planning/wavefront.py:relax_sweep_field``, and the pass counts are the
twin's.

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). The launch is a PyTorch custom operator with a fake, so
``torch.export`` traces through it and CUDA graphs capture it. On CPU tensors
``relax_sweep_field_cuda`` runs the twin; on CUDA tensors it launches the
kernel or raises — it never falls back.

The kernel has two forms. The shared form (the operator ``relax_sweep``) is
the design above, for lattices whose replica of the field fits a CTA's shared
memory (1440p's 72x128 at k = 7 or 8). The global form (the operator
``relax_sweep_global``, the same schema) keeps one copy of the field a stream
in device memory, shared by the cluster's CTAs, and the levels of each CTA's
lines after it, and takes any lattice of lines of at most 256 cells (4K
UHD's 108x192 at k = 6); its scratch comes from the caching allocator inside
the operator. ``launch_plan`` chooses the
form and k; ``form="global"`` forces the global form at any size, for the
checks.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import re
import time

import torch

from vision_assist_tpu_torch.planning.wavefront import relax_sweep_field
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc, ptxas_entries

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "relax_sweep.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
MAX_LINE = 256         # kMaxSlots * kWarp in csrc/relax_sweep.cu
MAX_CLUSTER = 8        # kMaxCluster: the portable cluster size
WARPS = 32             # kMaxWarps: the most warps a CTA runs
SHARED_CAP = 232448 - 512   # an H100 block's opt-in shared memory less the kernel's static
FORMS = ("shared", "global")

# Kernel launches since the last reset_launches(); one per operator call on
# CUDA tensors (B streams share a launch), and the same by form.
launches = 0
launches_by_form = dict.fromkeys(FORMS, 0)

_lib = None
build_log = ""
build_seconds = 0.0
compiled = False       # False when build() reused an earlier build's library


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_form.update(dict.fromkeys(FORMS, 0))


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_log, build_seconds, compiled
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib_path, build_log, compiled = compile_shared(
        nvcc(), NVCC_FLAGS, SOURCE, "relax_sweep")
    lib = ctypes.CDLL(str(lib_path))
    lib.relax_sweep_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.relax_sweep_launch.restype = ctypes.c_int
    for name in ("relax_sweep_shared_bytes", "relax_sweep_level_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
        getattr(lib, name).restype = ctypes.c_longlong
    lib.relax_sweep_shared_cap.argtypes = [ctypes.c_int]
    lib.relax_sweep_shared_cap.restype = ctypes.c_int
    lib.relax_sweep_max_line.restype = ctypes.c_int
    lib.relax_sweep_max_cluster.restype = ctypes.c_int
    if (lib.relax_sweep_max_line(), lib.relax_sweep_max_cluster()) != (MAX_LINE, MAX_CLUSTER):
        raise RuntimeError(f"{SOURCE.name} takes lines of {lib.relax_sweep_max_line()} "
                           f"cells and clusters of {lib.relax_sweep_max_cluster()}, this "
                           f"wrapper expects {MAX_LINE} and {MAX_CLUSTER}")
    for rows, cols, k in ((32, 32, 1), (64, 36, 2), (54, 96, 4), (1, 256, 8),
                          (20, 90, 3), (108, 192, 6), (256, 256, 8)):
        if (lib.relax_sweep_shared_bytes(rows, cols, k),
                lib.relax_sweep_level_bytes(rows, cols, k)) \
                != (shared_bytes(rows, cols, k), level_bytes(rows, cols, k)):
            raise RuntimeError(f"{SOURCE.name} lays out its memory unlike "
                               "cuda_sweep.shared_bytes and level_bytes")
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def _ceil_log2(x: int) -> int:
    return 0 if x <= 1 else 1 + _ceil_log2((x + 1) // 2)


def shared_bytes(rows: int, cols: int, k: int) -> int:
    """Dynamic shared memory of one CTA of a rows x cols lattice in a
    cluster of k CTAs a stream: the replica of the field (its four
    directions, rows x (cols | 1) float32 each) and the b levels 0.. of the
    CTA's own lines, level 0 being the entry costs, except where they are
    in registers: lines of at most 32 cells whose crossing lines are at most
    96 (``layout`` and ``in_registers`` in the source)."""
    def kept(n, other, per):
        return 0 if n <= 32 and other <= 96 else per * _ceil_log2(n) * n

    return 4 * (4 * rows * (cols | 1) + kept(cols, rows, -(-rows // k))
                + kept(rows, cols, -(-cols // k)))


def level_bytes(rows: int, cols: int, k: int) -> int:
    """The global form's kept levels of one CTA of a rows x cols lattice in
    a cluster of k CTAs, in device memory after the fields: the b levels of
    its own lines, level 0 the entry costs."""
    return 4 * (-(-rows // k) * _ceil_log2(cols) * cols
                + -(-cols // k) * _ceil_log2(rows) * rows)


def field_bytes(rows: int, cols: int) -> int:
    """The global form's field a stream in device memory: four directions,
    rows x (cols | 1) float32 each."""
    return 16 * rows * (cols | 1)


def min_cluster(rows: int, cols: int) -> int:
    """The fewest CTAs a stream that give each warp at most one line a side."""
    return -(-max(rows, cols) // WARPS)


def takes(rows: int, cols: int, k: int) -> bool:
    """Whether the kernel takes a rows x cols lattice in clusters of k CTAs
    a stream: each warp at most one line a side, and the shared memory
    within a CTA's."""
    return (max(rows, cols) <= MAX_LINE and min_cluster(rows, cols) <= k <= MAX_CLUSTER
            and shared_bytes(rows, cols, k) <= SHARED_CAP)


def cluster_size(rows: int, cols: int) -> int:
    """The CTAs a stream the launch takes for a rows x cols lattice. In the
    shared form, by the device times of every k on the six sweep inputs of
    ``chip_smoke.py`` (``PERF.md`` section 6): one CTA while both
    sides are at most 32 cells (the served 32x32 lattice: every k > 1 was
    slower), else 4 CTAs (the fastest or within 1 % of it at 64x36 and
    54x96), or more where a side is longer than 128 cells or 4 CTAs' shared
    memory does not hold it: the fewest that give each warp at most one line
    a side and fit. Where no cluster of up to 8 holds the shared form, the
    global form's: the fewest that give each warp at most one line a side
    (6 at 4K UHD's 108x192). Raises ValueError for lines longer than 256
    cells."""
    if max(rows, cols) > MAX_LINE or min(rows, cols) < 1:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice; the kernel takes "
                         f"lines of 1 to {MAX_LINE} cells")
    first = 1 if max(rows, cols) <= WARPS else max(4, min_cluster(rows, cols))
    for k in range(first, MAX_CLUSTER + 1):
        if takes(rows, cols, k):
            return k
    return min_cluster(rows, cols)


def launch_plan(rows: int, cols: int, cluster: int = 0, form: str | None = None
                ) -> tuple[str, int]:
    """(form, k) of the launch for a rows x cols lattice: ``cluster`` CTAs a
    stream (0: ``cluster_size``'s choice, or for a forced global form the
    fewest), in the shared form where it takes the lattice at
    that k, else the global form; ``form`` forces one. Raises ValueError,
    before any launch, for lines longer than 256 cells, a k outside [the
    fewest, 8], and a forced shared form that does not fit."""
    if form not in (None, *FORMS):
        raise ValueError(f"relax_sweep kernel: form {form!r}, not one of {FORMS}")
    if max(rows, cols) > MAX_LINE or min(rows, cols) < 1:
        raise ValueError(f"relax_sweep_field_cuda: a {rows}x{cols} lattice; the "
                         f"kernel takes lines of 1 to {MAX_LINE} cells")
    k = int(cluster) or (min_cluster(rows, cols) if form == "global"
                         else cluster_size(rows, cols))
    if not min_cluster(rows, cols) <= k <= MAX_CLUSTER:
        raise ValueError(f"relax_sweep_field_cuda: clusters of {k} CTAs for a {rows}x{cols} "
                         f"lattice; the kernel takes {min_cluster(rows, cols)} to "
                         f"{MAX_CLUSTER}")
    fits = takes(rows, cols, k)
    if form == "shared" and not fits:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice in clusters of {k} "
                         f"needs {shared_bytes(rows, cols, k)} bytes of shared memory a CTA "
                         f"in the shared form; a CTA has {SHARED_CAP}")
    return form or ("shared" if fits else "global"), k


_INSTANCE = re.compile(r"\w*relax_sweep_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?")
_FORM_OF = {None: "shared", "0": "shared", "1": "global"}


def instances(log: str) -> list[dict]:
    """Each kernel instance ``ptxas -v`` reports in ``log``: its form
    ("shared" or "global"), the slots of a row and of a column, registers a thread, stack
    frame, spill stores and spill loads (bytes; summed over every function
    ptxas lists with it)."""
    out = []
    for entry in ptxas_entries(log):
        m = _INSTANCE.match(entry.pop("name"))
        if m:
            out.append({"form": _FORM_OF[m.group(3)],
                        "slots": (int(m.group(1)), int(m.group(2))), **entry})
    return out


@functools.lru_cache(maxsize=None)
def _shared_cap(index: int) -> int:
    """Shared memory one block may have on card ``index`` (asked once)."""
    return build().relax_sweep_shared_cap(index)


def _launch(form: str, enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
            max_passes: int, cluster: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel's ``form`` on the inputs' card, the outputs
    (and the global form's fields and levels) from the caching allocator;
    raises if the launch fails."""
    global launches
    dev = enter.device
    b, rows, cols = enter.shape
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    scratch, need = None, 0
    if form == "shared":
        need = lib.relax_sweep_shared_bytes(rows, cols, cluster)
    else:   # the fields of the B streams, then the levels of their B * k CTAs
        scratch = torch.empty(
            (b * (field_bytes(rows, cols) + cluster * level_bytes(rows, cols, cluster)) // 4,),
            dtype=torch.float32, device=dev)
    cap = _shared_cap(index)
    if need > cap:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice in clusters of "
                         f"{cluster} needs {need} bytes of shared memory a CTA in the "
                         f"{form} form, a CTA has {cap}")
    ins = [x.contiguous() for x in (enter, start, turn)]
    out = torch.empty((b, rows, cols, 4), dtype=torch.float32, device=dev)
    passes = torch.empty((b,), dtype=torch.int32, device=dev)
    scans = torch.empty((b, 2), dtype=torch.int32, device=dev)
    err = lib.relax_sweep_launch(*(x.data_ptr() for x in ins), out.data_ptr(),
                                 passes.data_ptr(), scans.data_ptr(), b, rows, cols,
                                 max_passes, cluster,
                                 None if scratch is None else scratch.data_ptr(), index,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice in clusters of "
                         f"{cluster}: lines of at most {MAX_LINE} cells, "
                         f"{min_cluster(rows, cols)} to {MAX_CLUSTER} CTAs a stream, and "
                         f"in the global form 2**31 floats of scratch")
    if err == -2:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice in clusters of "
                         f"{cluster} does not fit a CTA's shared memory in the {form} form")
    if err == -3:
        raise RuntimeError(f"relax_sweep kernel: no cluster of {cluster} CTAs with "
                           f"{need} bytes of shared memory can be placed on the card")
    if err != 0:
        raise RuntimeError(f"relax_sweep kernel ({form} form) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_by_form[form] += 1
    return out, passes, scans


@torch.library.custom_op("vision_assist_tpu_torch::relax_sweep",
                         mutates_args=(), device_types="cuda")
def _sweep_op(enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
              max_passes: int, cluster: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the shared form over (B, R, C) float32 entry costs,
    (B, 2) int32 starts and the (4, 4) float32 turn costs, ``cluster`` CTAs
    a stream -> dist (B, R, C, 4), passes (B,), and the line scans each
    stream ran (B, 2): of rows, of columns. The lines the need flags skip
    are not counted, so the scans are the work this run's data needed
    (``chip_smoke.py`` builds the kernel's bound from them)."""
    return _launch("shared", enter, start, turn, max_passes, cluster)


@torch.library.custom_op("vision_assist_tpu_torch::relax_sweep_global",
                         mutates_args=(), device_types="cuda")
def _sweep_global_op(enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
                     max_passes: int, cluster: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relax_sweep``'s global form: the same inputs and outputs, the field
    and the levels in device memory allocated here."""
    return _launch("global", enter, start, turn, max_passes, cluster)


def _fake(enter, start, turn, max_passes, cluster):
    b, rows, cols = enter.shape
    return (enter.new_empty((b, rows, cols, 4)),
            enter.new_empty((b,), dtype=torch.int32),
            enter.new_empty((b, 2), dtype=torch.int32))


_sweep_op.register_fake(_fake)
_sweep_global_op.register_fake(_fake)


def relax_sweep_field_cuda(enter: torch.Tensor, start: torch.Tensor,
                           turn: torch.Tensor, max_passes: int | None = None,
                           cluster: int = 0, form: str | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, passes (B,) int32), both equal to the plain twin
    ``relax_sweep_field``, which runs instead for a CPU tensor. At most
    ``max_passes`` passes (default R*C, which never binds). ``cluster`` CTAs
    a stream on the card and ``form`` as ``launch_plan`` takes them (0 and
    None: its choice)."""
    if enter.device.type == "cpu":
        return relax_sweep_field(enter, start, turn, max_passes)
    if enter.device.type != "cuda":
        raise ValueError(f"relax_sweep_field_cuda: unsupported device {enter.device}")
    if enter.dim() != 3 or start.shape != (enter.shape[0], 2) \
            or turn.shape != (4, 4) or enter.shape[0] < 1:
        raise ValueError(f"relax_sweep_field_cuda: bad shapes enter "
                         f"{tuple(enter.shape)} start {tuple(start.shape)} turn "
                         f"{tuple(turn.shape)}")
    _, rows, cols = enter.shape
    if any(x.device != enter.device for x in (start, turn)):
        raise ValueError("relax_sweep_field_cuda: the inputs lie on different devices")
    chosen, k = launch_plan(rows, cols, cluster, form)
    op = (torch.ops.vision_assist_tpu_torch.relax_sweep if chosen == "shared"
          else torch.ops.vision_assist_tpu_torch.relax_sweep_global)
    dist, passes, _ = op(enter.float(), start.to(torch.int32), turn.float(),
                         rows * cols if max_passes is None else int(max_passes), k)
    return dist, passes
