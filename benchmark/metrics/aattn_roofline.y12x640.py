"""The area attention's share of its roofline in the traced window: the
least time of the attention products (operations at the bf16 peak against
q, k, v and the output in bf16 at the memory rate, counted from the
configuration's shapes, ``harness/attention.py``) over the device time of
the pinned attention kernel by name."""

from benchmark.harness.attention import roofline as read  # noqa: F401
