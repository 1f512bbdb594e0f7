"""The five CBFuse fusions' share of their roofline in the traced window:
their least time (each piece read once, the target read once and the result
written once, in bf16 at the memory rate, counted from the reference's
shapes, ``harness/cbfuse.py``) over the device time of the fused kernel by
name."""

from benchmark.harness.cbfuse import roofline as read  # noqa: F401
