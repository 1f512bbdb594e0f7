"""Training data: labels, rasterised targets, the batch loader and the
device-side photometric augmentation."""
