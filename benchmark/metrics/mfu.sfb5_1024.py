"""The whole step's share of the card's bf16 dense peak in the SegFormer-B5
cell: the segmenter's FLOPs a frame (counted on the configuration's own
reference, ``reference/segformer.py``, the attention products included)
times the frames answered in the window, over the card's busy seconds in
it."""

from benchmark.harness.readers import mfu as read  # noqa: F401
