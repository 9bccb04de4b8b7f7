"""The device's idle share (%) in the traced stretch of a stream."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
