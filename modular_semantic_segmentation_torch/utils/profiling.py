"""Timing on the card (counterpart of the JAX package's
``utils/profiling.py``).

    * :func:`trace`: a torch.profiler trace of the CPU and the card,
      written for TensorBoard / Perfetto;
    * :func:`cold_ms`: mean device time of a call, CUDA events, each call
      after an L2 flush;
    * :func:`kernel_ms`: device time per call of named kernels, from
      torch.profiler.

All of them need a CUDA card; none falls back to the CPU.
"""

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace of the CPU and the card into
    ``logdir`` (one Chrome-trace JSON file); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _flush_buffer():
    """1 GiB whose zeroing (about 0.3 ms) pushes the inputs of a timed call
    out of the 50 MB L2 cache and keeps the card busy while the host
    queues the call, so host overhead does not show as device time."""
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
    return sum(start.elapsed_time(end) for start, end in events) / iters


def kernel_ms(fn, name, iters=20):
    """Device time per call of the kernels whose name contains ``name``,
    from torch.profiler, each call after an L2 flush; None when the
    profiler records no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    flush = _flush_buffer()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if name in e.key]
    total_us = sum(e.self_device_time_total for e in found)
    return total_us / 1e3 / iters if total_us > 0 else None
