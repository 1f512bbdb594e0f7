"""The NMS kernel's share of its roofline in the traced window: the least
time the card could take for each launch over the kernel's device time by
name; the one-camera cells."""

from benchmark.harness.readers import nms_roofline as read  # noqa: F401
