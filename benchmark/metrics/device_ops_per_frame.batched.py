"""Device operations (kernels, copies, sets) in the traced window over the
frames it answered; the cells of many cameras."""

from benchmark.harness.readers import device_ops_per_frame as read  # noqa: F401
