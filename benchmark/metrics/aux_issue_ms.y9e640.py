"""Median host ms a step spends inside the program's
``program.segment.aux`` span (YOLOv9's first backbone and its five
CBLinears, one a step), over the traced window's steps."""

from benchmark.harness.program_spans import read_step_ms


def read(run):
    return read_step_ms(run, "program.segment.aux")
