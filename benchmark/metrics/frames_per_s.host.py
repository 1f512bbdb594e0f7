"""Frames of every stream answered in the window over the window's seconds
by the host's clock; in the batched loop the window closes once every step
fed in it has retired. Paced by the host, whose speed drifts, so kept per
layer."""

from benchmark.harness.stats import rate


def read(run):
    return rate(run.frames_done, run.window_s)
