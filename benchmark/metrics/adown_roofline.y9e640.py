"""The 8 ADowns' pools' share of their roofline in the traced window: their
least time (each input read once, the first half's averages and the second
half's max pool written once, in bf16 at the memory rate, counted from the
reference's shapes, ``harness/adown.py``) over the device time of the ADown
kernel by name."""

from benchmark.harness.adown import roofline as read  # noqa: F401
