"""Share of the traced window in which no device operation ran: one minus
the union of the device's activity intervals over the window; the one-camera cells."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
