"""Median host ms a step spends inside the program's
``program.segment.esa`` spans (one an efficient self-attention block, 52 a
step of SegFormer-B5), summed by step, over the traced window's steps."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "program.segment.esa")
