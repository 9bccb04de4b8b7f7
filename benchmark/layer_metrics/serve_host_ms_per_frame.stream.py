"""Host milliseconds per dispatched frame of the serving loop's upload,
launches and readback (spans ``serve.upload``, ``serve.launch``,
``serve.readback``) in the traced stretch of a stream, over the
program's ``serve.frames``."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit(("serve.upload", "serve.launch", "serve.readback"),
                       "host_s", "serve.frames")
