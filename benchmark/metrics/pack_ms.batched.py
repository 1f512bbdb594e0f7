"""Median host ms a step in the program's ``pack`` span (the numpy I420
packer and the stack of the step's frames) over the traced window's steps;
the cells of many cameras."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "pack")
