"""Pipelined single-frame inference serving (counterpart of the JAX
package's ``serving.py``: ``InferenceServer`` and ``serve_frames``).

Each frame runs the batch-1 inference of the model. Frames go in groups of
``unroll``; the tail group is padded by repeating its last frame, as in the
JAX package, whose group program has a static frame count. Up to
``max_in_flight`` groups are queued before the oldest is read back.

On the card the loop runs on the current stream: frames go up from pinned
memory without blocking the host, and each group's outputs come back into
pinned memory behind a CUDA event, so reading group i waits for group i
only while later groups keep the card busy. CUDA graphs come later.
"""

from collections import deque

import numpy as np
import torch

from modular_semantic_segmentation_torch.models.estimator import to_numpy


class InferenceServer:
    """Streaming frame-at-a-time inference over an Estimator.

    The serving mode (float, or int8 with the estimator's
    ``act_scales``) is fixed when the first group is dispatched, as the
    JAX package's server fixes it when it traces its group program: a
    server that has served keeps its mode across a later
    ``quantize_for_serving`` or ``dequantize_serving``.

    Args:
        estimator: any Estimator of the port (expert or fusion model).
        unroll: frames per group.
        max_in_flight: groups queued before blocking on the oldest
            readback (2 = double buffering).
        output_attr: which ``_test_outputs`` entry to return per frame.
    """

    def __init__(self, estimator, unroll=4, max_in_flight=2,
                 output_attr="prediction"):
        if unroll < 1 or max_in_flight < 1:
            raise ValueError("unroll and max_in_flight must be >= 1")
        self._net = estimator
        self.unroll = unroll
        self.max_in_flight = max_in_flight
        self._attr = output_attr
        self._act_scales = None
        self._mode_fixed = False

    def group_program(self, frame_batches):
        """Run one group of batch-1 frames already on the model's device
        (``{"rgb": [1, H, W, 3], ...}`` each) and return their outputs,
        queued on the device: the JAX package's ``group_program``, whose
        variables and random key the port's model holds itself. The first
        call fixes the serving mode."""
        net = self._net
        if not self._mode_fixed:
            self._act_scales = net.act_scales
            self._mode_fixed = True
        return [net._forward_with_scales(batch, self._act_scales)[self._attr]
                for batch in frame_batches]

    def _dispatch(self, frames):
        """Queue one (possibly short) group. Returns (outputs, valid,
        event): host tensors that hold the outputs once ``event`` (None
        on the CPU) has completed."""
        net = self._net
        valid = len(frames)
        padded = frames + [frames[-1]] * (self.unroll - valid)
        outs = self.group_program([net._batch_to_device(
            {k: v[None] if hasattr(v, "ndim") else np.asarray(v)[None]
             for k, v in frame.items()}) for frame in padded])
        if net.device.type != "cuda":
            return outs, valid, None
        host = []
        for out in outs[:valid]:
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            buf.copy_(out, non_blocking=True)
            host.append(buf)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(net.device))
        return host, valid, event

    def predict_stream(self, frames):
        """Yield one output per input frame, in order, pipelined.

        Args:
            frames: iterable of blob dicts with UNBATCHED arrays
                (e.g. ``{"rgb": [H, W, 3], "depth": [H, W, 1]}``).
        """
        in_flight = deque()
        group = []

        def drain(limit):
            while len(in_flight) > limit:
                outs, valid, event = in_flight.popleft()
                if event is not None:
                    event.synchronize()
                for out in outs[:valid]:
                    yield to_numpy(out)[0]

        for frame in frames:
            group.append(frame)
            if len(group) == self.unroll:
                in_flight.append(self._dispatch(group))
                group = []
                yield from drain(self.max_in_flight - 1)
        if group:
            in_flight.append(self._dispatch(group))
        yield from drain(0)

    def predict(self, frames):
        """Stacked array of outputs for a finite frame iterable."""
        return np.stack(list(self.predict_stream(frames)))


def serve_frames(estimator, frames, **kwargs):
    """One-shot convenience: ``InferenceServer(estimator, **kwargs)
    .predict(frames)``."""
    return InferenceServer(estimator, **kwargs).predict(frames)
