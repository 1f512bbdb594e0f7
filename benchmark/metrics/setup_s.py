"""Seconds from the process's start to the first timed frame."""


def read(run):
    return run.setup_s
