"""Stream milliseconds per step of the optimizer's update and its
application (span ``fit.optimizer``, its CUDA events) in the traced
``fit`` call, over the program's ``fit.steps``: the card's time while
the host launches ahead of it, else an upper bound at the host's pace."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit(("fit.optimizer",), "stream_s", "fit.steps")
