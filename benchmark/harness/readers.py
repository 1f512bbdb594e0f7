"""What the per-layer metrics read from a run, shared by the metrics that
read one quantity in cells of different kinds (``.sync`` and ``.batched``
move different end-to-end metrics). Which cells report a metric is
``BENCHMARK.json``'s to say; a reader returns None where the run has
nothing to read."""

from benchmark.harness.peaks import BF16_DENSE_FLOPS, anchors_at, astar_bound_s, nms_bound_s
from benchmark.harness.stats import percentile


def span_ms(run, name: str) -> float | None:
    """Median host ms of the serving loop's ``name`` call."""
    values = run.spans.get(name)
    return percentile(values, 50) * 1e3 if values else None


def device_ops_per_frame(run) -> float | None:
    """Kernels, copies and sets in the traced window over the frames it answered."""
    if run.trace is None:
        return None
    frames = sum(len(step) for step in run.trace_launches)
    ops = len(run.trace.in_window())
    return ops / frames if frames and ops else None


def idle_share(run) -> float | None:
    """One minus the union of the device's activity intervals over the
    traced window, in %."""
    if run.trace is None or not run.trace.in_window():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def nms_roofline(run) -> float | None:
    """The least time the card could take for each NMS launch (bytes over
    the memory rate against operations over the float32 rate, from the
    benchmark's own count of each frame's candidates) over the kernel's
    device time by name, in %."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds("nms_kernel")
    if not launches or seconds <= 0:
        return None
    anchors = anchors_at(run.cell.config["imgsz"])
    bound = sum(nms_bound_s(anchors, [run.seg[a.pool_index].n_candidates for a in step],
                            [a.n_detections for a in step])
                for step in run.trace_launches)
    return 100.0 * bound / seconds


def astar_roofline(run) -> float | None:
    """The A* kernel's least time by bytes alone (the pops a search makes
    are not known to the benchmark) over its device time by name, in %."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds("astar")
    if not launches or seconds <= 0:
        return None
    t = run.cell.traffic
    g = run.cell.config["grid_size"]
    cells = (t["frame_height"] // g) * (t["frame_width"] // g)
    bound = launches * astar_bound_s(t["streams"], cells, goals=8, max_len=512)
    return 100.0 * bound / seconds


def card_ms_per_frame(run) -> float | None:
    """The card's busy time in the window (the union of its kernels, copies
    and sets) over the frames answered in it, in ms."""
    if not run.card_busy_s or not run.frames_done:
        return None
    return 1e3 * run.card_busy_s / run.frames_done


def mfu(run) -> float | None:
    """The segmenter's convolution and matmul FLOPs a frame (counted on the
    benchmark's own reference model at the configuration's imgsz) times the
    frames answered in the window, over the card's busy seconds in it and
    its bf16 dense peak, in %: the whole step's share of the peak while the
    card works, which ``card_ms_per_frame`` bounds."""
    if not run.flops_per_frame or not run.card_busy_s:
        return None
    return 100.0 * run.flops_per_frame * run.frames_done / run.card_busy_s / BF16_DENSE_FLOPS
