"""Kernel launches per fused frame in the traced stretch of a stream."""

from benchmark.harness.readers import launches_per_unit as read  # noqa: F401
