"""The pinned attention kernel's device seconds over the card's busy
seconds in the traced window, in %: the share of the card the area
attention takes."""

from benchmark.harness.attention import card_share as read  # noqa: F401
