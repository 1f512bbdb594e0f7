"""The whole step's share of the card's bf16 dense peak: the segmenter's
FLOPs a frame times the frames answered in the window over the card's busy
seconds in it; the one-camera cells."""

from benchmark.harness.readers import mfu as read  # noqa: F401
