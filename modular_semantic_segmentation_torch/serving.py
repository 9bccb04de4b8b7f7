"""Pipelined single-frame inference serving, and the deployment artifact
(counterpart of the JAX package's ``serving.py``: ``InferenceServer``,
``serve_frames``, ``export_serving`` and ``ExportedServing``).

Each frame runs the batch-1 inference of the model. Frames go in groups of
``unroll``; the tail group is padded by repeating its last frame, as in the
JAX package, whose group program has a static frame count. Up to
``max_in_flight`` groups are queued before the oldest is read back.

On a CUDA card the server replays a captured CUDA graph of the group
program, so the host launches one graph a group where the eager program
launches hundreds of kernels (334 a fused VGG16-FCN frame). The first
group of each key (group size, each input's shape and dtype,
``output_attr`` and the serving mode) runs eagerly on a side stream,
which fills the model's ``ops.layers.KernelCache``; the second is
captured with ``torch.cuda.CUDAGraph`` and replayed, as is every later
one. A graph replays the weights it captured: when any object of the
model's ``_serving_state`` (its variables; DirichletFusion's kernel
tables too) is no longer the one captured, or a variable has been written
in place since, the key is warmed and captured anew. The graph also keeps what the cache held at its capture (the
weights in the compute dtype, the int8 operands), which new weights or a
forward at other scales replace there. A group's frames are written into
pinned staging buffers, one set for each of the ``max_in_flight`` slots,
a set rewritten only once the group that last read it has completed; they
go up to the graph's static inputs on the current stream before the
replay, and the static outputs come back into fresh pinned buffers behind
the group's CUDA event, before the next replay on the stream can
overwrite them.

Families served from graphs: SimpleFCN, Adapnet, FusionFCN,
ProgressiveFCN, BayesFusion, AverageFusion, DirichletFusion with
``use_pallas`` (kernel B), and VarianceFusion and BayesianFCN without MC
dropout (dropout rate 0, or one sample). Served eagerly, by the rules of
:func:`eager_reason`: VarianceFusion and BayesianFCN with MC dropout
(their forward draws from the model's generator), DirichletFusion without
``use_pallas`` and UncertaintyDirichletFusion (their fusion copies host
arrays to the device every frame), a model distributed over a mesh by
the parallel layer, and every model on the CPU; so is a group whose
frames differ in shape. On the card an eager group still uploads from
pinned memory without blocking the host and reads back behind an event.

While a profiler records, each group's upload, launch (the replay, or
the eager program with its stream time) and readback, and the wait for
its outputs, are spans ``serve.*`` of ``utils/tracing.py`` sharing the
group's request id; ``serve.capture`` covers a warm-up and a capture.
The counters ``serve.frames``, ``serve.padded_frames``,
``serve.upload_bytes``, ``serve.readback_bytes`` and ``serve.frames_read``
count what they move, ``serve.graph_captures`` and ``serve.graph_replays``
the graphs, ``serve.eager_groups`` the groups the eager program served on
the card (warm-ups included). A replay runs no Python of the model: the
spans and counters inside the forward (``fusion.*``, ``upsample.*``,
``layers.kernel_cache_miss``) record only its warm-up.

``export_serving`` writes a model's inference program as a
``torch.export`` program beside its weights; ``ExportedServing`` runs it
without the model classes (it imports ``torch`` and the kernels'
registered operators, ``ops/cuda/library.py``, and no module of
``models/``).
"""

import gc
import json
import os
from collections import OrderedDict, deque
from functools import partial

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops.layers import KernelCache
from modular_semantic_segmentation_torch.ops.variables import (
    DEFAULT_GENERATOR, Ctx, resolve_device)
from modular_semantic_segmentation_torch.utils import tracing
from modular_semantic_segmentation_torch.utils.data_io import to_numpy

#: captured graphs a server keeps, the least recently replayed dropped
#: first: each holds its own pool of device memory
MAX_GRAPHS = 8


def eager_reason(estimator):
    """Why ``InferenceServer`` runs ``estimator``'s groups eagerly on any
    device, or None when it captures them on a card: the model is
    distributed over a mesh (its collectives pass between ranks), or its
    family says why (``Estimator._eager_serving_reason``)."""
    if estimator._parallel is not None:
        return "distributed over a mesh by the parallel layer"
    return estimator._eager_serving_reason()


def _frame_tensor(value):
    """A frame's unbatched array as a tensor (numpy and lists are
    wrapped, not copied where they are contiguous). Its batch of one is
    ``t[None]``, whose batch dimension has a stride: numpy's ``v[None]``
    gives it stride 0, for which PyTorch suggests NCHW and cuDNN runs
    every convolution of an NHWC frame between two layout transposes."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _read_back(outs, device):
    """Copies of ``outs`` in fresh pinned buffers, queued on the current
    stream, and the event after them."""
    host = []
    for out in outs:
        buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        buf.copy_(out, non_blocking=True)
        host.append(buf)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event


class CudaGraphs:
    """Warm-up, capture and replay of group programs on one card, and the
    pinned staging and device buffers around them."""

    def __init__(self, device):
        self.device = device
        self._side = torch.cuda.Stream(device)

    def staging(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def buffer(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=self.device)

    def upload(self, dst, src):
        dst.copy_(src, non_blocking=True)

    def warm(self, program):
        """Run ``program`` eagerly on a side stream that waits for the
        current one, as PyTorch's capture recipe asks; returns its
        outputs, ready in the current stream's order."""
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            outs = program()
        current.wait_stream(self._side)
        for out in outs:
            out.record_stream(current)
        return outs

    def capture(self, program):
        """(graph, static outputs) of ``program``. The cyclic garbage
        collector is off meanwhile: a collection could destroy another
        graph, which CUDA forbids while a stream captures."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                outs = program()
        finally:
            if collecting:
                gc.enable()
        return graph, outs

    def replay(self, graph):
        graph.replay()

    def readback(self, outs):
        return _read_back(outs, self.device)

    def release(self, entry):
        """Wait for the card before a captured entry is dropped: its
        graph's memory pool may still be read by a queued readback."""
        torch.cuda.synchronize(self.device)


def _graph_backend(device):
    """The capture backend of ``device``: CUDA graphs on a card, None
    (eager serving) elsewhere."""
    return CudaGraphs(device) if device.type == "cuda" else None


class _StagingSet:
    """One slot's host buffers, ``{name: [1, ...]}`` a frame, and the
    event of the group that last read them (None before the first)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors):
        self.tensors = tensors
        self.event = None


class _Captured:
    """One key's static device inputs (``{name: [1, ...]}`` a frame), its
    staging sets, the serving state it was made for and, once captured,
    its graph, static outputs and the model's kernel-cache entries the
    graph reads. It holds no reference to its server, so a server is
    freed as soon as it is dropped, never by a collection during another
    capture."""

    __slots__ = ("inputs", "staging", "slot", "state", "warmed", "graph",
                 "outputs", "pinned")

    def __init__(self, inputs, staging, state):
        self.inputs = inputs
        self.staging = staging
        self.slot = 0
        self.state = state
        self.warmed = False
        self.graph = None
        self.outputs = None
        self.pinned = ()


def _versioned(state):
    """Each object of a model's serving state with its
    ``KernelCache.version`` where it is a tensor: a graph replays the
    weights the kernel cache derived at its capture, so a variable written
    in place calls for a capture anew, as a new object does."""
    return tuple((obj, KernelCache.version(obj) if torch.is_tensor(obj)
                  else None) for obj in state)


def _same_state(a, b):
    return len(a) == len(b) and all(
        x is y and vx == vy for (x, vx), (y, vy) in zip(a, b))


class InferenceServer:
    """Streaming frame-at-a-time inference over an Estimator.

    The serving mode (float, or int8 with the estimator's
    ``act_scales``) is fixed when the first group is dispatched, as the
    JAX package's server fixes it when it traces its group program: a
    server that has served keeps its mode across a later
    ``quantize_for_serving`` or ``dequantize_serving``. So is the choice
    between captured graphs and the eager program (module docstring).

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
        self._mode_key = None
        self._backend = None
        self._graphs = OrderedDict()

    def _fix_mode(self):
        if self._mode_fixed:
            return
        net = self._net
        self._act_scales = net.act_scales
        self._mode_key = (None if self._act_scales is None
                          else tuple(sorted(self._act_scales.items())))
        if eager_reason(net) is None:
            self._backend = _graph_backend(net.device)
        self._mode_fixed = True

    def group_program(self, frame_batches):
        """Run one group of batch-1 frames already on the model's device
        (``{"rgb": [1, H, W, 3], ...}`` each) and return their outputs,
        queued on the device: the JAX package's ``group_program``, whose
        variables and random key the port's model holds itself, run
        eagerly. The first call fixes the serving mode."""
        self._fix_mode()
        net = self._net
        return [net._forward_with_scales(batch, self._act_scales)[self._attr]
                for batch in frame_batches]

    def _dispatch(self, frames):
        """Queue one (possibly short) group. Returns (outputs, valid,
        event, request): host tensors that hold the outputs once ``event``
        (None on the CPU) has completed, and the group's request id for
        its spans (None while no profiler records)."""
        self._fix_mode()
        valid = len(frames)
        padded = frames + [frames[-1]] * (self.unroll - valid)
        request = tracing.request_id()
        tensors = [{k: _frame_tensor(v) for k, v in frame.items()}
                   for frame in padded]
        signatures = {tuple((k, tuple(t.shape), t.dtype)
                            for k, t in frame.items()) for frame in tensors}
        staged = None
        if self._backend is not None and len(signatures) == 1:
            outs, staged = self._dispatch_graph(tensors, signatures.pop(),
                                                request)
            nbytes = sum(t.nbytes for bufs in staged.tensors
                         for t in bufs.values())
        else:
            outs, nbytes = self._dispatch_eager(tensors, request)
        if request is not None:
            tracing.count("serve.frames", valid)
            tracing.count("serve.padded_frames", self.unroll - valid)
            tracing.count("serve.upload_bytes", nbytes)
        with tracing.span("serve.readback", request=request):
            if self._backend is not None:
                host, event = self._backend.readback(outs[:valid])
            elif self._net.device.type == "cuda":
                host, event = _read_back(outs[:valid], self._net.device)
            else:
                host, event = outs, None
        if staged is not None:
            staged.event = event
        if request is not None:
            tracing.count("serve.readback_bytes",
                          sum(t.nbytes for t in host[:valid]))
        return host, valid, event, request

    def _dispatch_eager(self, tensors, request):
        """The eager group program over frames uploaded by
        ``_batch_to_device``. Returns (outputs, bytes uploaded)."""
        net = self._net
        with tracing.span("serve.upload", request=request):
            batches = [net._batch_to_device({k: t[None]
                                             for k, t in frame.items()})
                       for frame in tensors]
        with tracing.span("serve.launch", device=net.device,
                          request=request):
            outs = self.group_program(batches)
        if net.device.type == "cuda":
            tracing.count("serve.eager_groups")
        return outs, sum(t.nbytes for batch in batches
                         for t in batch.values())

    def _entry(self, signature):
        """The captured entry of ``signature``'s key, made anew (the stale
        one released) when the model's serving state has changed."""
        key = (self.unroll, signature, self._attr, self._mode_key)
        state = _versioned(self._net._serving_state())
        entry = self._graphs.get(key)
        if entry is not None and _same_state(entry.state, state):
            self._graphs.move_to_end(key)
            return entry
        backend, n = self._backend, self.unroll
        if entry is not None:
            backend.release(self._graphs.pop(key))
        # a buffer a frame, each allocated as the eager upload's is
        inputs = [{k: backend.buffer((1,) + shape, dtype)
                   for k, shape, dtype in signature} for _ in range(n)]
        staging = [_StagingSet([{k: backend.staging((1,) + shape, dtype)
                                 for k, shape, dtype in signature}
                                for _ in range(n)])
                   for _ in range(self.max_in_flight)]
        entry = _Captured(inputs, staging, state)
        self._graphs[key] = entry
        if len(self._graphs) > MAX_GRAPHS:
            backend.release(self._graphs.popitem(last=False)[1])
        return entry

    def _dispatch_graph(self, tensors, signature, request):
        """Stage the group, upload it to its key's static inputs and replay
        the key's graph, after a warm-up or a capture where it has none.
        Returns (outputs on the device, the staging set used)."""
        backend = self._backend
        entry = self._entry(signature)
        with tracing.span("serve.upload", request=request):
            staged = entry.staging[entry.slot]
            entry.slot = (entry.slot + 1) % len(entry.staging)
            if staged.event is not None:
                # the group that last read this set must have completed
                staged.event.synchronize()
            for frame, bufs, inputs in zip(tensors, staged.tensors,
                                           entry.inputs):
                for k, buf in bufs.items():
                    buf[0].copy_(frame[k])
                    backend.upload(inputs[k], buf)
        program = partial(self.group_program, entry.inputs)
        with tracing.span("serve.launch", device=self._net.device,
                          request=request):
            if not entry.warmed:
                with tracing.span("serve.capture"):
                    outs = backend.warm(program)
                entry.warmed = True
                tracing.count("serve.eager_groups")
                return outs, staged
            if entry.graph is None:
                with tracing.span("serve.capture"):
                    entry.graph, entry.outputs = backend.capture(program)
                # a graph holds no reference to tensors made outside its
                # pool: keep the cached weights and int8 operands it read
                # alive, which new weights or a forward at other scales
                # replace in the cache
                entry.pinned = self._net._kernel_cache.held()
                tracing.count("serve.graph_captures")
            backend.replay(entry.graph)
            tracing.count("serve.graph_replays")
        return entry.outputs, staged

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
    dropout drawing from the device's default generator and a
    ``KernelCache.decided`` from the estimator's weights."""

    def __init__(self, net, output_attr):
        super().__init__()
        self._net = net
        self._attr = output_attr
        self._kernel_cache = KernelCache.decided(net.variables)

    def forward(self, variables, batch):
        net = self._net
        ctx = Ctx(variables, compute_dtype=net.compute_dtype,
                  kernel_cache=self._kernel_cache,
                  generator=DEFAULT_GENERATOR, act_scales=net.act_scales)
        return net._test_outputs(ctx, net._preprocess(batch))[self._attr]


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
    program = _ServingProgram(net, output_attr)
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
        cuda = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[self.device] if cuda else []):
            if cuda:
                torch.cuda.manual_seed(seed)
            else:
                torch.manual_seed(seed)
            with torch.inference_mode():
                out = self._program(self._variables, inputs)
        return to_numpy(out)
