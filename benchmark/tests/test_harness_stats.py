"""The arithmetic of the end-to-end metrics and of the device's idle share."""

import numpy as np
import pytest

from benchmark.harness.stats import gaps, merged, percentile, rate, union_length


def test_percentiles_take_every_frame_and_a_stall_shows_in_the_tail():
    ms = [40.0] * 95 + [300.0] * 5            # five frames stalled
    assert percentile(ms, 50) == 40.0
    assert percentile(ms, 95) == pytest.approx(np.percentile(ms, 95))
    assert percentile(ms, 99) == 300.0
    assert percentile(ms, 96) == 300.0


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys_linear_rule(q):
    xs = list(np.random.default_rng(3).lognormal(3.5, 0.4, 321))
    assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_rate_counts_all_the_work_over_all_the_time():
    # 100 frames in 4 s with a 1 s stall among them: 25 frames/s, not the
    # 33.3 of the frames outside the stall.
    assert rate(100, 4.0) == 25.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_idle_share_is_one_minus_the_union_of_overlapping_intervals():
    # Two streams' kernels overlap: [0, 4] and [2, 6] are busy 6, not 8.
    intervals = [(0, 4), (2, 6), (8, 9), (8.5, 8.7)]
    assert union_length(intervals) == 7
    assert merged(intervals) == [(0, 6), (8, 9)]
    window = (0, 10)
    idle = gaps(intervals, *window)
    assert idle == [(6, 8), (9, 10)]
    assert sum(e - s for s, e in idle) + union_length(intervals) == 10


def test_gaps_clip_to_the_window():
    assert gaps([(-5, 1), (3, 20)], 0, 10) == [(1, 3)]
    assert gaps([], 0, 2) == [(0, 2)]
