"""The ADown kernel's device seconds over the card's busy seconds in the
traced window, in %."""

from benchmark.harness.adown import card_share as read  # noqa: F401
