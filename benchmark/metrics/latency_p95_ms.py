"""95th percentile of the same frames' host ms as ``latency_p50_ms``."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile(run.frame_ms, 95) if run.frame_ms else None
