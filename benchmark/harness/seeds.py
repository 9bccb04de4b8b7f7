"""Independent seeds for each part of a run, derived from ``--seed``."""

import numpy as np

PARTS = ("weights", "matrices", "frames", "program", "sample", "extra")


def derive(seed):
    """``{part: int in [0, 2**31)}`` for any whole ``seed`` >= 0."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    state = np.random.SeedSequence(int(seed)).generate_state(len(PARTS))
    return {part: int(s) & 0x7FFFFFFF for part, s in zip(PARTS, state)}
