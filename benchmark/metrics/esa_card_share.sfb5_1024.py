"""The pinned attention kernel's device seconds over the card's busy
seconds in the traced window, in %: the share of the card SegFormer's
efficient self-attention takes (``harness/attention.py``'s reader: the
same kernel as YOLO12's area attention)."""

from benchmark.harness.attention import card_share as read  # noqa: F401
