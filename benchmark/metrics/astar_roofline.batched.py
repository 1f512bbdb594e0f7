"""The A* kernel's share of its roofline in the traced window, by bytes
alone (the pops a search makes are not known to the benchmark): each
launch's least time over the kernel's device time by name."""

from benchmark.harness.readers import astar_roofline as read  # noqa: F401
