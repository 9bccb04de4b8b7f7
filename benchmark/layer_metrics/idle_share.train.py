"""The device's idle share (%) in the traced ``fit`` call."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
