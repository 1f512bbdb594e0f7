"""The traced window's reading: device busy time, idle gaps by what the
host was doing, the slowest frames, kernels by name."""

from benchmark.harness.trace import Trace, breakdown, slow_frames

MS = 1_000_000


def _trace():
    host = sorted([
        ("bench.window", 0, 100 * MS),
        ("bench.frame", 0, 40 * MS), ("bench.submit", 0, 30 * MS),
        ("aten::copy_", 1 * MS, 20 * MS), ("cudaStreamSynchronize", 2 * MS, 19 * MS),
        ("bench.retire", 30 * MS, 40 * MS),
        ("bench.frame", 40 * MS, 100 * MS), ("bench.submit", 40 * MS, 50 * MS),
        ("bench.retire", 50 * MS, 100 * MS), ("numpy_host_half", 55 * MS, 95 * MS),
    ], key=lambda x: (x[1], -x[2]))
    device = [("conv_kernel", 20 * MS, 25 * MS), ("nms_kernel(float const*)", 24 * MS, 26 * MS),
              ("Memcpy DtoH", 45 * MS, 50 * MS)]
    return Trace((0, 100 * MS), device, host,
                 [(s, e) for n, s, e in host if n == "bench.frame"])


def test_busy_is_a_union_and_kernels_are_found_by_name():
    tr = _trace()
    assert abs(tr.busy_s() - 0.011) < 1e-12          # [20, 26] and [45, 50]
    assert tr.window_s == 0.1
    launches, seconds = tr.kernel_seconds("nms_kernel")
    assert launches == 1 and abs(seconds - 0.002) < 1e-12


def test_idle_gaps_are_labelled_by_span_and_innermost_op():
    b = breakdown(_trace())
    names = dict(b["idle_gaps"])
    # [0, 20]: inside submit's cudaStreamSynchronize at 10 ms.
    assert abs(names["submit:cudaStreamSynchronize"] - 0.020) < 1e-12
    # [26, 45] midpoint 35.5: retire of frame 0, no op open.
    assert abs(names["retire:python"] - 0.019) < 1e-12
    # [50, 100] midpoint 75: the host half inside retire.
    assert abs(names["retire:numpy_host_half"] - 0.050) < 1e-12
    assert b["device_ops"][0][0] == "conv_kernel"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_slowest_frames_list_what_overlapped_them():
    slow = slow_frames(_trace(), k=1)
    assert slow[0]["frame_in_trace"] == 1 and abs(slow[0]["ms"] - 60.0) < 1e-9
    assert [op[0] for op in slow[0]["device_ops"]] == ["Memcpy DtoH"]
    assert "numpy_host_half" in [op[0] for op in slow[0]["host_ops"]]
    assert abs(slow[0]["device_busy_share"] - 5 / 60) < 1e-9
