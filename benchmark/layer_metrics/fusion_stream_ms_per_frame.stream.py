"""Stream milliseconds per dispatched frame of the fusion model's epilogue
(span ``fusion.epilogue``, its CUDA events) in the traced stretch of a
stream, over the program's ``serve.frames``: an upper bound of the card's
time, which reads the host's pace where the card waits for its
launches."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit(("fusion.epilogue",), "stream_s", "serve.frames")
