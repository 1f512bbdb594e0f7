"""Median host ms a step in the program's ``program`` span (every launch of
the device program issued) over the traced window's steps; the cells of
many cameras."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "program")
