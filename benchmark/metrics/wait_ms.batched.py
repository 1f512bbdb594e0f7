"""Median host ms a step in the program's ``wait`` span (the host waiting
for the payload's copy from the card) over the traced window's steps; the
cells of many cameras."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "wait")
