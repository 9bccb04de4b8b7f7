"""Timing (counterpart of the JAX package's ``utils/profiling.py``).

    * :func:`trace`: a torch.profiler trace of the CPU and the card,
      written for TensorBoard / Perfetto;
    * :func:`time_fn`: synchronous latency and pipelined throughput of a
      call on the host clock (the timing CLI's primitive);
    * :func:`log_compile_time`: wall clock of a first call;
    * :func:`device_time_fn`: seconds per call by the loop-difference
      method;
    * :func:`cold_ms`: mean device time of a call, CUDA events, each call
      after an L2 flush;
    * :func:`kernel_ms`: device time per call of named kernels, from
      torch.profiler.

``time_fn``, ``log_compile_time`` and ``device_time_fn`` wait for the card
where the call's outputs lie on it, and time the CPU where they lie there;
``trace``, ``cold_ms`` and ``kernel_ms`` need a CUDA card and do not fall
back to the CPU.
"""

import contextlib
import os
import time

import numpy as np
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


def _tensors(out):
    """The tensors of a (nested) output: tensors, dicts, lists, tuples."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for value in out.values():
            yield from _tensors(value)
    elif isinstance(out, (list, tuple)):
        for value in out:
            yield from _tensors(value)


def _wait(out):
    """Return once every kernel queued for the output has run: a
    ``torch.cuda.synchronize`` of each card the output lies on (nothing to
    wait for on the CPU, whose calls return finished)."""
    for device in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, repetitions=50, warmup=3):
    """Time ``fn(*args)`` on the host clock, as the JAX package's
    ``time_fn`` does.

    Returns a dict with:
        sync_mean_s / sync_std_s: per-call latency, each call followed by
            a wait for the card (``torch.cuda.synchronize``);
        pipelined_mean_s / pipelined_fps: ``repetitions`` calls queued
            back to back and one wait after the last, per call: the
            per-frame cost of a serving loop that keeps the card fed.

    Eager PyTorch launches every kernel from the host, so where the call
    is host bound (its launches take longer than its kernels) the
    pipelined time is the host's launch time, not the card's.
    """
    _wait(fn(*args))
    for _ in range(warmup):
        _wait(fn(*args))

    sync = []
    for _ in range(repetitions):
        start = time.perf_counter()
        _wait(fn(*args))
        sync.append(time.perf_counter() - start)

    start = time.perf_counter()
    outs = [fn(*args) for _ in range(repetitions)]
    _wait(outs)
    pipelined = (time.perf_counter() - start) / repetitions

    return {
        "sync_mean_s": float(np.mean(sync)),
        "sync_std_s": float(np.std(sync)),
        "pipelined_mean_s": float(pipelined),
        "pipelined_fps": float(1.0 / pipelined),
    }


def log_compile_time(fn, *args):
    """Wall clock of the first call and its wait (in the JAX package, its
    compile). Returns (seconds, result)."""
    start = time.perf_counter()
    result = fn(*args)
    _wait(result)
    return time.perf_counter() - start, result


def device_time_fn(fn, *args, iters=50, repetitions=5, n2=None):
    """Seconds per ``fn(*args)`` by the JAX package's loop-difference
    method.

    Runs ``iters`` and ``n2`` (default ``4 * iters``) calls back to back,
    each run ended by one wait, takes the least wall time of each length
    over ``repetitions`` runs, and divides the difference of the two
    floors by ``n2 - iters``: the constant cost of a run (its first
    launch, its wait) cancels. Every call gets the same ``args``; nothing
    it returns is fed back.

    The JAX package runs the loop on the device (``lax.fori_loop``), so
    its difference holds device time alone. Eager PyTorch launches each
    call's kernels from the host, so where a call is host bound this is
    the host's launch time per call, the card idle between kernels: the
    counterpart of the JAX method in this runtime, not the card's busy
    time (``kernel_ms`` and ``cold_ms`` read that).

    Raises ValueError unless ``n2 > iters``.
    """
    n2 = 4 * iters if n2 is None else n2
    if n2 <= iters:
        raise ValueError(f"n2 ({n2}) must exceed iters ({iters})")

    def run(n):
        out = None
        for _ in range(n):
            out = fn(*args)
        _wait(out)

    run(1)  # warm up
    floors = {}
    for n in (iters, n2):
        best = float("inf")
        for _ in range(repetitions):
            start = time.perf_counter()
            run(n)
            best = min(best, time.perf_counter() - start)
        floors[n] = best
    return (floors[n2] - floors[iters]) / (n2 - iters)


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
