"""Arithmetic the per-layer metrics' readers share. Each returns None where
it finds nothing to read."""


def launches_per_unit(obs):
    """Kernel launches of the traced stretch over its frames or steps."""
    if obs.trace is None or obs.trace.units <= 0:
        return None
    return obs.trace.launches / obs.trace.units


def idle_share(obs):
    """100 x (1 - the union of device activity / the traced stretch)."""
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    return 100.0 * obs.trace.idle_share


def mfu(obs, flops_per_unit, units, peak_key):
    """100 x FLOPs of the window's work / its seconds / the card's peak."""
    if obs.peaks is None or not obs.window["seconds"] > 0:
        return None
    rate = flops_per_unit * units / obs.window["seconds"]
    return 100.0 * rate / obs.peaks[peak_key]
