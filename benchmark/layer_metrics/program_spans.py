"""Arithmetic of the per-layer metrics read from the program's own spans
and counters (``modular_semantic_segmentation_torch.utils.tracing``).

The program records them only while a torch profiler records, so in a
traced run its snapshot covers the traced stretch alone. A metric is the
milliseconds of the named spans, host or stream time, over one of the
program's counters (the frames it dispatched or read back, or its
steps): in a stream, groups in flight straddle the stretch's edges, so
the frames delivered would not match the spans. Each returns None where
the program has no tracer, the counter is 0, or a span it needs is
missing or has no stream time.
"""


def snapshot():
    """The program's tracer snapshot, or None where it has no tracer: these
    readers may run over a version of the program from before it had one,
    whose traced runs then report none of their metrics."""
    try:
        from modular_semantic_segmentation_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def ms_per_unit(names, key, counter, prefixes=()):
    """1e3 x the sum of ``key`` ('host_s' or 'stream_s') over the spans
    ``names`` and those whose name starts with one of ``prefixes``, over
    the counter ``counter``."""
    snap = snapshot()
    if snap is None:
        return None
    units = snap["counters"].get(counter, 0)
    spans = snap["spans"]
    chosen = [spans.get(name) for name in names]
    chosen += [s for name, s in spans.items() if name.startswith(prefixes)]
    if units <= 0 or not chosen or any(
            s is None or s[key] is None for s in chosen):
        return None
    return 1e3 * sum(s[key] for s in chosen) / units
