"""Milliseconds of device activity (the union of kernels, copies and
fills) per frame in the traced stretch of the camera."""


def read(obs):
    if obs.trace is None or obs.trace.units <= 0:
        return None
    return 1e3 * obs.trace.busy_s / obs.trace.units
