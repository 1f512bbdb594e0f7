"""Share of the traced window in which no device operation ran and the host
was inside the program's ``pack`` span; the cells of many cameras."""

from benchmark.harness.program_spans import read_idle_in


def read(run):
    return read_idle_in(run, "pack")
