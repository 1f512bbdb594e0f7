"""Median host ms of the serving loop's retire call (a step of every stream): the wait
for the payload, unpacking, the host half and the analyser; the cells of many cameras."""

from benchmark.harness.readers import span_ms


def read(run):
    return span_ms(run, "retire")
