"""The whole step's share of the card's bf16 dense peak in the YOLOv9e-seg
cell: the segmenter's FLOPs a frame (counted on the configuration's own
reference, ``reference/yolov9.py``, both branches of every RepConv) times
the frames answered in the window, over the card's busy seconds in it."""

from benchmark.harness.readers import mfu as read  # noqa: F401
