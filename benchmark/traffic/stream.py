"""The closed-loop stream: distinct frames of a pool in host memory,
cycled, through ``InferenceServer.predict_stream``; the next frame is
handed over as soon as the server asks for it. ``serve_fps`` is the frames
delivered to the host over the window.

Parameters (``traffic/<mix>.json``): ``pool_frames``, ``unroll``,
``max_in_flight``, ``warmup_frames``, ``checked_frames`` (the seeded
sample of outputs compared with the reference), ``trace_skip`` and
``trace_frames`` (the traced stretch, in outputs).
"""

import numpy as np

from benchmark.harness.serving import (ServingClient, now, program_output,
                                       record)


class Client(ServingClient):

    def window(self, seconds, stretch=None):
        pool, unroll = self.pool, self.traffic["unroll"]
        sample = self.new_sample()
        skip, traced = (self.traffic["trace_skip"],
                        self.traffic["trace_frames"])
        start = now()
        deadline = start + seconds

        fed = [0]

        def frames():
            while fed[0] % unroll or now() < deadline:
                with record("hand_over"):
                    frame = pool[fed[0] % len(pool)]
                fed[0] += 1
                yield frame

        delivered = 0
        with program_output():
            outputs = self.server.predict_stream(frames())
            while True:
                with record("await_output"):
                    out = next(outputs, None)
                if out is None:
                    break
                index = delivered % len(pool)
                sample.offer(lambda: (index, np.array(out)))
                delivered += 1
                if stretch is not None:
                    if delivered == skip:
                        stretch.begin()
                    elif delivered == skip + traced:
                        stretch.end(traced)
        elapsed = now() - start
        return {"metrics": {"serve_fps": delivered / elapsed},
                "units": delivered, "seconds": elapsed,
                "attempted": fed[0], "failed": fed[0] - delivered}
