"""The open-loop camera: one frame due every ``1 / rate_hz`` seconds on
the camera's clock, from a pool in host memory, through
``InferenceServer(unroll=1, max_in_flight=1).predict_stream``. The frame
iterator waits for a frame's due time in a busy loop on the clock, as a
capture thread that polls the camera does, and hands the frame over; a
frame's latency runs from its due time to its labels on the host, so a
stall is charged to the frames behind it. (Sleeping instead, on an H100
80GB HBM3 host, the iterator handed frames over 0.7 ms late at the median
and up to 28 ms late; polling, 0.1 ms at the median.) ``frame_p95_ms`` is
the 95th percentile over every frame due in the window. How late the
iterator handed frames over is printed.

Parameters: ``rate_hz``, ``pool_frames``, ``unroll``, ``max_in_flight``,
``warmup_frames``, ``checked_frames``, ``trace_skip``, ``trace_frames``.
"""

import statistics
import sys

import numpy as np

from benchmark.harness.serving import (ServingClient, now, program_output,
                                       record)


def p95(values):
    """The 95th percentile, ``statistics.quantiles``' inclusive method."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Client(ServingClient):

    def window(self, seconds, stretch=None):
        pool = self.pool
        period = 1.0 / self.traffic["rate_hz"]
        count = int(round(seconds * self.traffic["rate_hz"]))
        sample = self.new_sample()
        skip, traced = (self.traffic["trace_skip"],
                        self.traffic["trace_frames"])
        due, late = [], []
        start = now()

        def frames():
            for i in range(count):
                t = start + i * period
                with record("wait_due"):
                    while now() < t:
                        pass
                with record("hand_over"):
                    late.append(now() - t)
                    due.append(t)
                    frame = pool[i % len(pool)]
                yield frame

        latencies = []
        with program_output():
            outputs = self.server.predict_stream(frames())
            while True:
                with record("await_output"):
                    out = next(outputs, None)
                if out is None:
                    break
                latencies.append(now() - due[len(latencies)])
                index = (len(latencies) - 1) % len(pool)
                sample.offer(lambda: (index, np.array(out)))
                if stretch is not None:
                    if len(latencies) == skip:
                        stretch.begin()
                    elif len(latencies) == skip + traced:
                        stretch.end(traced)
        elapsed = now() - start
        print(f"camera: {count} frames due at {self.traffic['rate_hz']} Hz; "
              f"handed over late by median {statistics.median(late) * 1e3:.3f}"
              f" ms, p95 {p95(late) * 1e3:.3f} ms, max {max(late) * 1e3:.3f} "
              f"ms; latency median {statistics.median(latencies) * 1e3:.3f} "
              f"ms, max {max(latencies) * 1e3:.3f} ms", file=sys.stderr)
        return {"metrics": {"frame_p95_ms": p95(latencies) * 1e3},
                "units": len(latencies), "seconds": elapsed,
                "attempted": count, "failed": count - len(latencies)}
