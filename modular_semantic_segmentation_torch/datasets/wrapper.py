"""Minimal data interface (the port's copy of the JAX package's
``datasets/wrapper.py``)."""


class DataWrapper:
    """Interface for providing data in batches."""

    def next(self):
        """Return next batch as dict {modality: array [batch, ...]}."""
        raise NotImplementedError
