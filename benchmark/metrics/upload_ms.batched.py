"""Median host ms a step in the program's ``upload`` span (the frames made
contiguous, pinned, their copy to the card issued) over the traced window's
steps; the cells of many cameras."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "upload")
