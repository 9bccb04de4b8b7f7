"""Kernel launches per training step in the traced ``fit`` call."""

from benchmark.harness.readers import launches_per_unit as read  # noqa: F401
