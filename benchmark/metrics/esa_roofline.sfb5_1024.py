"""The efficient self-attention's share of its roofline in the traced
window: the least time of the attention products (operations at the bf16
peak against q, k, v and the output in bf16 at the memory rate, counted
from the configuration's shapes, ``harness/esa.py``) over the device time
of the pinned attention kernel by name."""

from benchmark.harness.esa import roofline as read  # noqa: F401
