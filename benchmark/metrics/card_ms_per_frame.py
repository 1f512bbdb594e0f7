"""The card's busy time in the window (the union of its kernels, copies and
sets, from a profile of the card's activity alone over the whole window)
over the frames of every stream answered in it: the card time a frame
costs its operator."""

from benchmark.harness.readers import card_ms_per_frame as read  # noqa: F401
