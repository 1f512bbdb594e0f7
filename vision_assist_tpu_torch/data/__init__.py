"""Training data: labels, rasterised targets, the batch loader and the
device-side photometric augmentation."""

from vision_assist_tpu_torch.data.dataset import SegDataset, parse_label_file
from vision_assist_tpu_torch.data.loader import BatchLoader

__all__ = ["SegDataset", "parse_label_file", "BatchLoader"]
