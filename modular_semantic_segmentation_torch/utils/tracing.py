"""Spans and counters at the port's layer boundaries, recorded only while
a torch profiler records in this process.

    with tracing.span("serve.launch", device=net.device, request=rid):
        outs = group_program(batches)
    tracing.count("serve.frames", valid)

**On and off.** Both functions test ``torch.autograd.profiler
._is_profiler_enabled``, the flag that ``torch.profiler.profile`` (and
``utils/profiling.trace``) sets while it records. Off, ``span`` returns
one shared no-op context and ``count`` returns at once: no
``record_function``, no CUDA event, no clock read and no allocation.
While a program is traced by ``torch.export`` or compiled
(``torch.compiler.is_compiling()``), or captured into a CUDA graph
(``torch.cuda.is_current_stream_capturing()``), both stay off too, so no
exported program or graph holds a profiler range or an event, and no span
times the tracing.

**On**, a span enters ``record_function("mss." + name)``, so its range
lies in the profiler's Chrome trace on the clock of the kernels, copies
and idle gaps there, and keeps a record in memory: its name, start and
end on ``time.perf_counter_ns``, its parent span, its request id and its
thread. The spans of one request share its id: one per group a serving
loop dispatches, the step for ``fit``; a span given none takes its
parent's. A span given a CUDA ``device`` also records a pair of timing
events on that device's current stream, taken from a reused pool, and
its **stream time** is read from them at :func:`snapshot`: from its first
launch to the completion of its last, idle stretches of the stream
inside it included. Where the host runs ahead of the card that is the
card's time for the span's work; where the card waits for the host's
launches, as it may under a profiler that records every operator, it is
the host's pace, an upper bound of the card's time.

Records are kept in a ring of ``capacity`` (100,000); a record pushed out
adds one to the counter ``tracing.dropped``. The per-name totals that
:func:`snapshot` returns stay exact. Records and totals are guarded by a
lock: ``fit``'s prefetcher and the serving loop may trace from other
threads.

The port's counters: ``serve.*`` (``serving.py``), ``fit.steps``
(``models/estimator.py``), ``upsample.forward`` and ``upsample.adjoint``
(``ops/cuda/upsample.py``), and in ``ops/layers.py``
``layers.kernel_cache_miss`` (``KernelCache``), ``layers.epilogue_fused``
(a conv whose bias, rounding and ReLU ran as the epilogue kernel) and
``layers.epilogue_eager`` (a float-path conv with a bias that kept the
PyTorch chain), whose ratio is the kernel's share of such convs, and
``layers.weight_cached`` (a float-path conv that read its weight from the
``KernelCache``) and ``layers.weight_per_call`` (one that made its
weight for the call alone), whose ratio is the cache's share. A
replayed CUDA graph runs no Python, so the counters inside a model's
forward count its eager calls only.
"""

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

_clock = time.perf_counter_ns

# the context every span returns while off
_OFF = contextlib.nullcontext()

# pending device spans beyond which the completed ones are folded in
_FOLD_AT = 1024


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


def active():
    """True while a torch profiler records in this process, outside a
    program being exported or compiled and outside a CUDA graph capture
    on this thread's stream."""
    return (_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling()
            and not _capturing())


def _capturing():
    # a capture needs CUDA initialized; asked first, it also keeps a
    # build without CUDA from raising
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Tracer:
    """Spans, counters and their per-name totals (see the module's
    docstring); the module's functions use one process-wide instance."""

    def __init__(self, capacity=100_000):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool = {}
        self.reset()

    def reset(self):
        """Drop every record, total, counter and pending device span."""
        with self._lock:
            self._records = collections.deque(maxlen=self.capacity)
            self._totals = {}
            self._stream_s = {}
            self._pending = collections.deque()
            self._counters = {}
            self._seq = itertools.count(1)
            self._requests = itertools.count(1)

    def span(self, name, device=None, request=None):
        """A context that records the span ``name`` while a profiler
        records, else a shared no-op context.

        Args:
            device: the ``torch.device`` whose work the span launches; on
                a CUDA device its stream time is recorded too.
            request: the request id (:meth:`request_id`); None takes the
                enclosing span's.
        """
        if not active():
            return _OFF
        return _Span(self, name, device, request)

    def count(self, name, n=1):
        """Add ``n`` to the counter ``name`` while a profiler records."""
        if not active():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def request_id(self):
        """A new request id while on, else None."""
        return next(self._requests) if active() else None

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _events(self, device):
        with self._lock:
            pool = self._pool.setdefault(device, [])
            if pool:
                return pool.pop()
        return _cuda_event(), _cuda_event()

    def _close(self, span, end_ns):
        duration = end_ns - span.start_ns
        record = (span.seq, span.name, span.start_ns, end_ns, span.parent_seq,
                  span.request, threading.get_ident())
        with self._lock:
            if len(self._records) == self.capacity:
                self._counters["tracing.dropped"] = (
                    self._counters.get("tracing.dropped", 0) + 1)
            self._records.append(record)
            totals = self._totals.setdefault(span.name, [0, 0, 0])
            totals[0] += 1
            totals[1] += duration
            totals[2] += duration - span.child_ns
            if span.events is not None:
                self._pending.append((span.name, span.device, span.events))
                if len(self._pending) > _FOLD_AT:
                    self._fold(wait=False)

    def _fold(self, wait):
        """Add the stream time of pending device spans to their totals and
        return their events to the pool: every one with ``wait``, else
        those whose end has completed, oldest first. Holds the lock."""
        while self._pending:
            name, device, (start, end) = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            self._stream_s[name] = (self._stream_s.get(name, 0.0)
                                    + 1e-3 * start.elapsed_time(end))
            self._pool.setdefault(device, []).append((start, end))

    def snapshot(self):
        """``{"spans": {name: {"calls", "host_s", "self_host_s",
        "stream_s"}}, "counters": {name: n}}``. Waits for the pending
        device spans; ``stream_s`` is None for a span that recorded no
        events. Needs no profiler."""
        with self._lock:
            self._fold(wait=True)
            spans = {name: {"calls": calls, "host_s": 1e-9 * host,
                            "self_host_s": 1e-9 * own,
                            "stream_s": self._stream_s.get(name)}
                     for name, (calls, host, own) in self._totals.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def records(self):
        """The records kept, oldest first, as dicts: ``id``, ``name``,
        ``start_ns``, ``end_ns``, ``parent`` (the parent's id or None),
        ``request`` and ``thread``."""
        keys = ("id", "name", "start_ns", "end_ns", "parent", "request",
                "thread")
        with self._lock:
            return [dict(zip(keys, r)) for r in self._records]


class _Span:
    """A span while on (see ``Tracer.span``)."""

    __slots__ = ("tracer", "name", "device", "request", "seq", "parent",
                 "parent_seq", "child_ns", "start_ns", "events", "range")

    def __init__(self, tracer, name, device, request):
        self.tracer = tracer
        self.name = name
        self.device = (device.index if device.index is not None
                       else torch.cuda.current_device()) if (
            device is not None and device.type == "cuda") else None
        self.request = request
        self.events = None

    def __enter__(self):
        tracer = self.tracer
        stack = tracer._stack()
        self.parent = stack[-1] if stack else None
        self.parent_seq = None if self.parent is None else self.parent.seq
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.seq = next(tracer._seq)
        self.child_ns = 0
        self.range = record_function("mss." + self.name)
        self.range.__enter__()
        if self.device is not None:
            self.events = tracer._events(self.device)
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        end_ns = _clock()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        self.tracer._stack().pop()
        if self.parent is not None:
            self.parent.child_ns += end_ns - self.start_ns
        self.tracer._close(self, end_ns)
        return False


TRACER = Tracer()

# the module's interface: the process-wide tracer's methods
span = TRACER.span
count = TRACER.count
request_id = TRACER.request_id
snapshot = TRACER.snapshot
records = TRACER.records
reset = TRACER.reset
