"""Median host ms of every frame the window answered, as its loop times a
frame: in the one-camera loop from the frame handed to ``submit_frame``
(packing included) to ``retire_frame`` returning its result."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile(run.frame_ms, 50) if run.frame_ms else None
