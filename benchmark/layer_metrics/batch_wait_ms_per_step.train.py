"""Host milliseconds per step that ``fit`` waited for its next batch from
the prefetcher (span ``fit.next_batch``) in the traced ``fit`` call, over
the program's ``fit.steps``."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit(("fit.next_batch",), "host_s", "fit.steps")
