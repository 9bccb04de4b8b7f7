"""A torch.profiler trace of a steady stretch of the window, reduced to
what the per-layer metrics and the breakdown read.

The stretch is opened and closed by the traffic client (``Stretch.begin``
and ``Stretch.end`` around a whole number of frames or steps). Inside it
the benchmark's own ``record_function`` ranges (``bench.*``) name what
the host was doing. From the Chrome trace the profiler writes:

* device activity: kernels, copies and fills on the card; ``busy_s`` is
  the length of their union within the stretch;
* launches: the CUDA runtime and driver-API calls that launch a kernel
  (``cudaLaunchKernel``, ``cuLaunchKernel``, their ``Ex`` forms and graph
  launches) on any host thread within the stretch;
* idle gaps: the stretches of the union's complement, each named by the
  innermost ``bench.*`` range and the innermost operator or runtime call
  of the host's main thread at its middle.
"""

import bisect
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
STRETCH = "bench.traced_stretch"


def is_launch(name):
    return ("LaunchKernel" in name or "GraphLaunch" in name
            or "LaunchCooperativeKernel" in name)


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


class Summary:
    """What a traced stretch holds; times in seconds."""

    def __init__(self, window_s, busy_s, launches, units, device_ops,
                 idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.launches = launches
        self.units = units
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps

    @property
    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s


def _innermost(spans, t):
    """The name of the shortest span of ``spans`` [(start, end, name)]
    that holds ``t``."""
    best = None
    for start, end, name in spans:
        if start <= t <= end and (best is None
                                  or end - start < best[1] - best[0]):
            best = (start, end, name)
    return None if best is None else best[2]


def summarize(events, units, top=10):
    """A ``Summary`` of Chrome-trace ``events`` for a stretch of ``units``
    frames or steps."""
    stretch = [e for e in events if e.get("ph") == "X"
               and e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no traced stretch")
    main = stretch[0]
    s0, s1 = float(main["ts"]), float(main["ts"]) + float(main["dur"])
    device, launches, annotations, host = [], 0, [], []
    per_op = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if end < s0 or start > s1:
            continue
        if cat in DEVICE_CATS:
            lo, hi = max(start, s0), min(end, s1)
            device.append((lo, hi))
            per_op[name] = per_op.get(name, 0.0) + (hi - lo)
        elif cat in ("cuda_runtime", "cuda_driver") and is_launch(name):
            launches += 1
        if e.get("tid") != main.get("tid") or e.get("pid") != main.get(
                "pid"):
            continue
        if cat == "user_annotation" and name.startswith("bench.") \
                and name != STRETCH:
            annotations.append((start, end, name[len("bench."):]))
        elif cat in HOST_CATS:
            host.append((start, end, name))
    busy = union(device)
    busy_us = sum(end - start for start, end in busy)
    gaps, cursor = [], s0
    for start, end in busy:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < s1:
        gaps.append((cursor, s1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for start, end in gaps[:top]:
        mid = 0.5 * (start + end)
        # host calls that began before the middle; the longest call of a
        # stretch is far shorter than it, so a window of them suffices
        i = bisect.bisect_right(starts, mid)
        nearby = host[max(0, i - 2000):i]
        parts = [_innermost(annotations, mid) or "outside bench ranges",
                 _innermost(nearby, mid) or "python"]
        named.append([" / ".join(parts), (end - start) * 1e-6])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return Summary(window_s=(s1 - s0) * 1e-6, busy_s=busy_us * 1e-6,
                   launches=launches, units=units,
                   device_ops=[[name[:160], us * 1e-6] for name, us in ops],
                   idle_gaps=named)


class Stretch:
    """Profiles one stretch of a window: ``warm()`` in set-up, then
    ``begin()``, the work, ``end(units)`` with the number of frames or
    steps it held, and after the window ``finish()``, which reads the
    trace into ``summary``."""

    def __init__(self):
        self.summary = None
        self._prof = None
        self._range = None
        self._units = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self, device):
        """Start and stop the profiler once on a small operation, so that
        loading the CUDA tracing library (seconds) falls into set-up."""
        prof = self._profile()
        prof.start()
        torch.ones(1024, device=device).sum().item()
        torch.cuda.synchronize(device)
        prof.stop()

    def begin(self):
        self._prof = self._profile()
        self._prof.start()
        self._range = torch.autograd.profiler.record_function(STRETCH)
        self._range.__enter__()

    def end(self, units):
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self._units = units

    def close(self):
        """Stop a profiler that a failed window left running."""
        if self._prof is not None and self._units is None:
            self._prof.stop()
            self._prof = None

    def finish(self):
        if self._units is None:
            raise RuntimeError("the window ended before its traced stretch")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events, self._units)
