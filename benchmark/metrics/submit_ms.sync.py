"""Median host ms of the serving loop's submit call (a frame): packing,
upload, issuing the device program; the one-camera cells."""

from benchmark.harness.readers import span_ms


def read(run):
    return span_ms(run, "submit")
