"""The whole step's share of the card's bf16 dense peak in the YOLO12x-seg
cell: the segmenter's FLOPs a frame (counted on the configuration's own
reference, ``reference/yolo12.py``) times the frames answered in the window,
over the card's busy seconds in it."""

from benchmark.harness.readers import mfu as read  # noqa: F401
