"""Kernel launches per fused frame in the traced stretch of the camera."""

from benchmark.harness.readers import launches_per_unit as read  # noqa: F401
