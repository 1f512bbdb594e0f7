"""Median host ms a step spends inside the program's
``program.segment.aattn`` spans (one an attention block, 16 a step of
YOLO12x-seg), summed by step, over the traced window's steps."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "program.segment.aattn")
