"""Stream milliseconds per dispatched frame of the expert CNNs: the packed
stems and each expert (spans ``fusion.stems``, ``fusion.expert.<m>``,
their CUDA events) in the traced stretch of a stream, over the program's
``serve.frames``. The card's time where the host launches ahead of it;
where the profiled host is the slower, as it is at this configuration,
an upper bound that reads the host's pace."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit((), "stream_s", "serve.frames",
                       prefixes=("fusion.stems", "fusion.expert."))
