"""Pipelined single-frame inference serving, and the deployment artifact
(counterpart of the JAX package's ``serving.py``: ``InferenceServer``,
``serve_frames``, ``export_serving`` and ``ExportedServing``).

Each frame runs the batch-1 inference of the model. Frames go in groups of
``unroll``; the tail group is padded by repeating its last frame, as in the
JAX package, whose group program has a static frame count. Up to
``max_in_flight`` groups are queued before the oldest is read back.

On the card the loop runs on the current stream: frames go up from pinned
memory without blocking the host, and each group's outputs come back into
pinned memory behind a CUDA event, so reading group i waits for group i
only while later groups keep the card busy. CUDA graphs come later.

While a profiler records, each group's upload, launches (with their
stream time) and readback, and the wait for its outputs, are spans
``serve.*`` of ``utils/tracing.py`` sharing the group's request id, and
the counters ``serve.frames``, ``serve.padded_frames``,
``serve.upload_bytes``, ``serve.readback_bytes`` and
``serve.frames_read`` count what they move.

``export_serving`` writes a model's inference program as a
``torch.export`` program beside its weights; ``ExportedServing`` runs it
without the model classes (it imports ``torch`` and the kernels'
registered operators, ``ops/cuda/library.py``, and no module of
``models/``).
"""

import json
import os
from collections import deque

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops.variables import (
    DEFAULT_GENERATOR, Ctx, resolve_device)
from modular_semantic_segmentation_torch.utils import tracing
from modular_semantic_segmentation_torch.utils.data_io import to_numpy


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
        event, request): host tensors that hold the outputs once ``event``
        (None on the CPU) has completed, and the group's request id for
        its spans (None while no profiler records)."""
        net = self._net
        valid = len(frames)
        padded = frames + [frames[-1]] * (self.unroll - valid)
        request = tracing.request_id()
        with tracing.span("serve.upload", request=request):
            batches = [net._batch_to_device(
                {k: v[None] if hasattr(v, "ndim") else np.asarray(v)[None]
                 for k, v in frame.items()}) for frame in padded]
        with tracing.span("serve.launch", device=net.device,
                          request=request):
            outs = self.group_program(batches)
        if request is not None:
            tracing.count("serve.frames", valid)
            tracing.count("serve.padded_frames", self.unroll - valid)
            tracing.count("serve.upload_bytes", sum(
                t.nbytes for batch in batches for t in batch.values()))
        with tracing.span("serve.readback", request=request):
            if net.device.type != "cuda":
                host, event = outs, None
            else:
                host = []
                for out in outs[:valid]:
                    buf = torch.empty(out.shape, dtype=out.dtype,
                                      pin_memory=True)
                    buf.copy_(out, non_blocking=True)
                    host.append(buf)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(net.device))
        if request is not None:
            tracing.count("serve.readback_bytes",
                          sum(t.nbytes for t in host[:valid]))
        return host, valid, event, request

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
                outs, valid, event, request = in_flight.popleft()
                # no span stays open across a yield
                with tracing.span("serve.wait", request=request):
                    if event is not None:
                        event.synchronize()
                    arrays = [to_numpy(out)[0] for out in outs[:valid]]
                tracing.count("serve.frames_read", valid)
                yield from arrays

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


# --------------------------------------------------------- the deployment
# artifact

PROGRAM = "program.pt2"
WEIGHTS = "weights.npz"
META = "meta.json"


class _ServingProgram(torch.nn.Module):
    """The forward that ``export_serving`` traces: (variables, batch) ->
    the test output ``output_attr``, in the estimator's serving mode, with
    dropout drawing from the device's default generator."""

    def __init__(self, net, output_attr, channel_diagonal):
        super().__init__()
        self._net = net
        self._attr = output_attr
        self._channel_diagonal = channel_diagonal

    def forward(self, variables, batch):
        net = self._net
        ctx = Ctx(variables, compute_dtype=net.compute_dtype,
                  generator=DEFAULT_GENERATOR, act_scales=net.act_scales,
                  channel_diagonal=self._channel_diagonal)
        return net._test_outputs(ctx, net._preprocess(batch))[self._attr]


def _channel_diagonal(net, batch):
    """Whether each frozen deconv kernel of ``net`` is channel-diagonal,
    asked of the weights by one eager forward (``Ctx.channel_diagonal``:
    the traced program cannot ask)."""
    cache = {}
    with torch.inference_mode():
        ctx = Ctx(net.variables, compute_dtype=net.compute_dtype,
                  kernel_cache=cache, generator=DEFAULT_GENERATOR,
                  act_scales=net.act_scales)
        with torch.random.fork_rng(devices=_rng_devices(net.device)):
            net._test_outputs(ctx, net._preprocess(batch))
    return {key: entry[1] for key, entry in cache.items()
            if isinstance(entry[1], bool)}


def _rng_devices(device):
    return [device] if device.type == "cuda" else []


def export_serving(estimator, directory, example_batch,
                   output_attr="prediction", platforms=None):
    """Export the inference program for deployment without model code.

    Writes ``directory/program.pt2`` (``torch.export.save`` of the traced
    forward), ``weights.npz`` (the variables under their TF names, as the
    JAX package's sidecar) and ``meta.json`` (the JAX package's keys:
    ``output_attr``, ``platforms``, the seed's dtype and shape under
    ``rng_dtype`` / ``rng_shape``, and ``inputs``). ``ExportedServing``
    runs it.

    The weights stay a runtime input of the program, as in the JAX
    package: the same artifact runs retrained weights of the same shapes.
    The current serving mode is captured: after ``quantize_for_serving``
    the int8 path is exported, its per-channel kernel scales computed in
    the program from the weights input and its activation scales
    constants. Kernels A and B are in the program as the registered
    operators of ``ops/cuda/library.py``. Dropout draws from the device's
    default generator, which ``ExportedServing`` seeds for each call.

    Args:
        estimator: an Estimator of the port (expert or fusion model).
        directory: output directory (made if missing).
        example_batch: blob dict of BATCHED arrays fixing the input shapes
            and dtypes (static: one artifact per served shape).
        output_attr: which test output the program returns.
        platforms: the device type the program runs on ('cuda' or 'cpu');
            None = the estimator's device. The program computes on the
            device it was traced on.
    """
    net = estimator
    platform = net.device.type if platforms is None else (
        platforms if isinstance(platforms, str) else platforms[0])
    if platform != net.device.type:
        raise ValueError(f"the program of a model on {net.device} runs on "
                         f"{net.device.type}, not {platform}")
    batch = net._batch_to_device(example_batch)
    program = _ServingProgram(net, output_attr,
                              _channel_diagonal(net, batch))
    with torch.no_grad():
        exported = torch.export.export(program, (dict(net.variables),
                                                 batch))
    os.makedirs(directory, exist_ok=True)
    torch.export.save(exported, os.path.join(directory, PROGRAM))
    np.savez(os.path.join(directory, WEIGHTS),
             **{k: to_numpy(v) for k, v in net.variables.items()})
    with open(os.path.join(directory, META), "w") as f:
        json.dump({
            "output_attr": output_attr,
            "platforms": [platform],
            "rng_dtype": "int64",
            "rng_shape": [],
            "inputs": {k: {"shape": list(v.shape),
                           "dtype": str(v.dtype).replace("torch.", "")}
                       for k, v in batch.items()},
        }, f, indent=2)
    return directory


class ExportedServing:
    """Runs an ``export_serving`` artifact; needs ``torch`` and the
    kernels' registered operators, not the model code.

    >>> served = ExportedServing("/path/to/artifact")
    >>> prediction = served.predict({"rgb": rgb, "depth": depth})

    ``predict`` draws a fresh seed per call from a numpy generator seeded
    by ``seed`` and seeds the device's default generator with it inside
    ``torch.random.fork_rng`` (the caller's random state is left as it
    was), so MC-dropout programs sample afresh and a fixed ``seed`` gives
    a reproducible stream.

    The program runs on the device type it was exported for (the
    current card for 'cuda', which raises without one).
    """

    def __init__(self, directory, seed=0):
        # the kernels' operators first: the program names them, and
        # torch.export.load raises without them
        from modular_semantic_segmentation_torch.ops.cuda import \
            library  # noqa: F401
        with open(os.path.join(directory, META)) as f:
            self.meta = json.load(f)
        self.device = resolve_device(self.meta["platforms"][0])
        self._program = torch.export.load(
            os.path.join(directory, PROGRAM)).module()
        with np.load(os.path.join(directory, WEIGHTS)) as weights:
            self._variables = {k: torch.from_numpy(weights[k]).to(
                self.device) for k in weights.files}
        self._seeds = np.random.default_rng(seed)

    def predict(self, batch):
        """The program's output for a blob dict of batched arrays."""
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in batch.items()}
        seed = int(self._seeds.integers(2**63 - 1))
        with torch.random.fork_rng(devices=_rng_devices(self.device)):
            if self.device.type == "cuda":
                torch.cuda.manual_seed(seed)
            else:
                torch.manual_seed(seed)
            with torch.inference_mode():
                out = self._program(self._variables, inputs)
        return to_numpy(out)
