"""Host milliseconds per frame read back that the serving loop waited for
its outputs and took them into numpy (span ``serve.wait``) in the traced
stretch of the camera, over the program's ``serve.frames_read``."""

from benchmark.layer_metrics.program_spans import ms_per_unit


def read(obs):
    return ms_per_unit(("serve.wait",), "host_s", "serve.frames_read")
