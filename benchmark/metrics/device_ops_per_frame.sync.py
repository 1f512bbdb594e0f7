"""Device operations (kernels, copies, sets) in the traced window over the
frames it answered; the one-camera cells."""

from benchmark.harness.readers import device_ops_per_frame as read  # noqa: F401
