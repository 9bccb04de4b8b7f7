"""Device time of a call after an L2 flush, with CUDA events (a copy of
the port's ``utils/profiling.cold_ms``, kept here so that the yardstick
does not change with the program)."""

import torch


def _flush_buffer():
    """1 GiB whose zeroing pushes the inputs of a timed call out of the
    50 MB L2 cache and keeps the card busy while the host queues the call,
    so host overhead does not show as device time."""
    return torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")


def cold_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` (every kernel it launches, CUDA events)
    over ``iters`` calls, each after an L2 flush."""
    flush = _flush_buffer()
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    del flush
    return sum(start.elapsed_time(end) for start, end in events) / iters
