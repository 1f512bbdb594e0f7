"""Median host ms of the serving loop's submit call (a step of every stream): packing,
upload, issuing the device program; the cells of many cameras."""

from benchmark.harness.readers import span_ms


def read(run):
    return span_ms(run, "submit")
