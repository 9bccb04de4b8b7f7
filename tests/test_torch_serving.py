"""The port's InferenceServer against the JAX package's, on the CPU.

Bayes-fused experts at reduced size with the JAX weights carried across;
5 frames at ``unroll=2`` leave a tail group of one frame, which both pad
by repeating it. Served labels must be equal, in order; served
probabilities allclose at atol 1e-5 (float32).
"""

import contextlib
import weakref

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.serving import \
    InferenceServer as JaxServer
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops.layers import KernelCache
from modular_semantic_segmentation_torch.serving import (InferenceServer,
                                                         serve_frames)

NUM_CLASSES = 6
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
CONFIG = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
          "prefixes": {"rgb": "rgb", "depth": "depth"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process.

    With both frameworks' CPU thread pools in one process, a chunk of a
    parallel float32 elementwise op (exp) was seen, in about one run of
    six, to come out at ~1e-5 relative error instead of a few ulp; on
    one thread it did not recur in 25 runs. Single-process runs of the
    port alone are not affected."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    jnet = jax_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                  confusion_matrices=cms, **CONFIG)
    tnet = get_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                  confusion_matrices=cms, device="cpu",
                                  **CONFIG)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    return jnet, tnet


def _frames(n=5):
    rng = np.random.RandomState(1)
    return [{"rgb": (rng.rand(32, 48, 3) * 255).astype(np.float32),
             "depth": rng.rand(32, 48, 1).astype(np.float32)}
            for _ in range(n)]


def test_server_matches_jax_with_padded_tail(models):
    jnet, tnet = models
    frames = _frames()
    want = JaxServer(jnet, unroll=2).predict(frames)
    server = InferenceServer(tnet, unroll=2)
    got = list(server.predict_stream(iter(frames)))
    assert len(got) == len(frames)
    np.testing.assert_array_equal(np.stack(got), want)
    # frame by frame: the served label maps are the model's own, in order
    for frame, label in zip(frames, got):
        one = {k: v[None] for k, v in frame.items()}
        np.testing.assert_array_equal(label, tnet.predict(one)[0])


@pytest.mark.parametrize("unroll,max_in_flight", [(1, 1), (3, 2), (8, 3)])
def test_server_output_attr_and_ordering_match_jax(models, unroll,
                                                   max_in_flight):
    jnet, tnet = models
    frames = _frames(4)
    want = JaxServer(jnet, unroll=unroll, max_in_flight=max_in_flight,
                     output_attr="rgb_prob").predict(frames)
    got = serve_frames(tnet, frames, unroll=unroll,
                       max_in_flight=max_in_flight, output_attr="rgb_prob")
    assert got.shape == want.shape == (4, 32, 48, NUM_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_server_rejects_bad_settings(models):
    with pytest.raises(ValueError):
        InferenceServer(models[1], unroll=0)
    with pytest.raises(ValueError):
        InferenceServer(models[1], max_in_flight=0)


# ------------------------------------------------ the captured-graph path
#
# The graph path's bookkeeping, run on the CPU through a stand-in for
# capture whose stream runs its work only when an event behind it is
# waited for, as a card runs it later than the host queues it.


class _Stream:
    """Queued work, run in order up to an event when the event is waited
    for."""

    def __init__(self):
        self.queue = []
        self.done = 0

    def enqueue(self, fn):
        self.queue.append(fn)

    def run_until(self, mark):
        while self.done < mark:
            work, self.queue[self.done] = self.queue[self.done], None
            work()
            self.done += 1

    def flush(self):
        self.run_until(len(self.queue))


class _Event:
    def __init__(self, stream):
        self.stream = stream
        self.mark = len(stream.queue)

    def synchronize(self):
        self.stream.run_until(self.mark)


class _Graph:
    """Replays the captured program (a ``partial`` of the server's
    ``group_program``) into the outputs it returned; as on a card, no span
    or counter of the program records (the backend reads as capturing),
    and the graph holds no reference to the server."""

    def __init__(self, backend, program, outputs):
        self.backend = backend
        self.method = weakref.WeakMethod(program.func)
        self.args = program.args
        self.outputs = outputs

    def replay(self):
        with self.backend.capturing_now():
            for out, new in zip(self.outputs, self.method()(*self.args)):
                out.copy_(new)


class StandInGraphs:
    """``serving.CudaGraphs`` on the CPU: uploads, replays and readbacks
    queue on a lazy stream; a capture runs nothing and returns outputs
    filled with -1 until a replay writes them. An upload whose staging
    buffer was rewritten between its queueing and its run is counted in
    ``reused_in_flight``. While it captures or replays, ``capturing`` is
    True, which the ``stand_in`` fixture gives ``utils/tracing.py`` for
    the card's ``torch.cuda.is_current_stream_capturing()``."""

    def __init__(self):
        self.stream = _Stream()
        self.warms = self.captures = self.replays = 0
        self.released = []
        self.reused_in_flight = 0
        self.capturing = False

    @contextlib.contextmanager
    def capturing_now(self):
        self.capturing = True
        try:
            yield
        finally:
            self.capturing = False

    def staging(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    def buffer(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    def upload(self, dst, src):
        queued = src.clone()

        def run():
            if not torch.equal(src, queued):
                self.reused_in_flight += 1
            dst.copy_(src)
        self.stream.enqueue(run)

    def warm(self, program):
        self.stream.flush()
        self.warms += 1
        return program()

    def capture(self, program):
        self.stream.flush()
        self.captures += 1
        with self.capturing_now():
            outs = [torch.full_like(out, -1) for out in program()]
        return _Graph(self, program, outs), outs

    def replay(self, graph):
        self.replays += 1
        self.stream.enqueue(graph.replay)

    def readback(self, outs):
        host = [torch.empty_like(out) for out in outs]
        for h, out in zip(host, outs):
            self.stream.enqueue(lambda h=h, out=out: h.copy_(out))
        return host, _Event(self.stream)

    def release(self, entry):
        self.stream.flush()
        self.released.append(entry)


@pytest.fixture
def stand_in(monkeypatch):
    """Every server started in the test captures through one stand-in."""
    from modular_semantic_segmentation_torch import serving
    from modular_semantic_segmentation_torch.utils import tracing
    backend = StandInGraphs()
    monkeypatch.setattr(serving, "_graph_backend", lambda device: backend)
    monkeypatch.setattr(tracing, "_capturing", lambda: backend.capturing)
    return backend


def _fusion(seed=3, **config):
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    return get_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                  confusion_matrices=cms, device="cpu",
                                  seed=seed, **dict(CONFIG, **config))


def _distinct(n, shape=(32, 48), dtype=np.float32, seed=2):
    rng = np.random.RandomState(seed)
    return [{"rgb": (rng.rand(*shape, 3) * 255).astype(dtype),
             "depth": rng.rand(*shape, 1).astype(dtype)} for _ in range(n)]


def _one_by_one(net, frames, output_attr="prediction"):
    """Each frame's output from ``predict``, given the frame as the server
    uploads it: a batch of one with the batch's stride (numpy's
    ``v[None]`` has a zero stride there, which sends convolutions down
    another path)."""
    return np.stack([net.predict({k: np.stack([v]) for k, v in f.items()},
                                 output_attr=output_attr)[0]
                     for f in frames])


@pytest.mark.parametrize("unroll,max_in_flight,n", [
    (2, 2, 7), (1, 1, 4), (3, 2, 8), (4, 3, 13)])
def test_graph_path_serves_the_eager_outputs(stand_in, unroll,
                                             max_in_flight, n):
    """Distinct frames through warm-up, capture and replays give the eager
    forward's labels, in order; the padded tail group replays the one
    graph of the key; the counters count captures, replays and the
    warm-up group."""
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.utils import tracing
    net = _fusion()
    frames = _distinct(n)
    server = InferenceServer(net, unroll=unroll,
                             max_in_flight=max_in_flight)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = server.predict(frames)
    np.testing.assert_array_equal(got, _one_by_one(net, frames))
    groups = -(-n // unroll)
    assert (stand_in.warms, stand_in.captures) == (1, 1)
    assert stand_in.replays == groups - 1
    assert stand_in.reused_in_flight == 0
    assert len(server._graphs) == 1
    counters = tracing.snapshot()["counters"]
    assert counters["serve.eager_groups"] == 1
    assert counters["serve.graph_captures"] == 1
    assert counters["serve.graph_replays"] == groups - 1
    assert counters["serve.frames"] == n
    assert counters["serve.padded_frames"] == groups * unroll - n
    # a replay runs none of the forward's spans
    spans = tracing.snapshot()["spans"]
    assert spans["serve.capture"]["calls"] == 2
    assert spans["fusion.epilogue"]["calls"] == unroll


def test_graph_key_holds_group_shapes_dtypes_attr_and_mode(stand_in):
    """A key per group size, each input's shape and dtype, output_attr
    and serving mode: new shapes and dtypes are captured beside the first
    key, and each key's outputs are the eager ones."""
    net = _fusion()
    server = InferenceServer(net, unroll=2)
    batches = [_distinct(4), _distinct(4, shape=(64, 32)),
               _distinct(4, dtype=np.float64), _distinct(3, seed=5)]
    for frames in batches:
        np.testing.assert_array_equal(server.predict(frames),
                                      _one_by_one(net, frames))
    want = {(2, tuple((k, v.shape, torch.from_numpy(v).dtype)
                      for k, v in frames[0].items()), "prediction", None)
            for frames in batches[:3]}
    assert set(server._graphs) == want
    assert stand_in.captures == 3 and not stand_in.released

    probs = InferenceServer(net, unroll=2, output_attr="rgb_prob")
    frames = _distinct(4)
    np.testing.assert_array_equal(probs.predict(frames),
                                  _one_by_one(net, frames, "rgb_prob"))
    assert [key[2] for key in probs._graphs] == ["rgb_prob"]

    scales = {"rgb/conv3_1/input_amax": 2.0, "depth/conv4_1/input_amax": 1.5}
    float_server = InferenceServer(net, unroll=2)
    float_server.predict(frames)
    net.quantize_for_serving(scales)
    int8 = InferenceServer(net, unroll=2)
    np.testing.assert_array_equal(int8.predict(frames),
                                  _one_by_one(net, frames))
    assert [key[3] for key in int8._graphs] == [tuple(sorted(
        scales.items()))]
    # a server keeps the mode it fixed, and the key it made
    float_labels = float_server.predict(frames)
    assert [key[3] for key in float_server._graphs] == [None]
    net.dequantize_serving()
    np.testing.assert_array_equal(float_labels, _one_by_one(net, frames))


def _fresh_cache(net, frames):
    """``_one_by_one`` through a kernel cache that holds nothing yet, so
    that it reads no weight derived before."""
    held = net._kernel_cache
    net._kernel_cache = KernelCache()
    try:
        return _one_by_one(net, frames)
    finally:
        net._kernel_cache = held


def test_graph_recaptured_when_a_variable_changes_identity(stand_in):
    """A variable replaced by another tensor makes the key warm up and
    capture anew (the stale entry released), so no stale weights are
    replayed; so does a variable written in place, whose new values the
    graph captured anew reads, as a forward with a fresh kernel cache
    does."""
    net = _fusion()
    server = InferenceServer(net, unroll=2)
    frames = _distinct(6)
    server.predict(frames)
    assert (stand_in.warms, stand_in.captures) == (1, 1)
    name = "depth/score/kernel"
    net.variables[name] = net.variables[name] * -1.0
    np.testing.assert_array_equal(server.predict(frames),
                                  _one_by_one(net, frames))
    assert (stand_in.warms, stand_in.captures) == (2, 2)
    assert len(stand_in.released) == 1 and len(server._graphs) == 1
    before = server.predict(frames)
    net.variables[name].neg_()
    got = server.predict(frames)
    np.testing.assert_array_equal(got, _fresh_cache(net, frames))
    assert not np.array_equal(got, before)
    assert (stand_in.warms, stand_in.captures) == (3, 3)
    assert len(stand_in.released) == 2 and len(server._graphs) == 1
    net.variables = dict(net.variables)  # the same tensors
    server.predict(frames)
    assert stand_in.captures == 3


def test_a_graph_keeps_the_int8_operands_it_captured(stand_in):
    """A graph reads the int8 kernels and scales that the model's kernel
    cache holds at its capture, and a graph holds no reference to tensors
    made outside its pool. A forward at other scales replaces them in the
    cache; the captured entry keeps them alive, and the server that fixed
    the first scales still serves their labels."""
    import gc
    net = _fusion()
    scales = {"rgb/conv3_1/input_amax": 2.0, "depth/conv4_1/input_amax": 1.5}
    frames = _distinct(4)
    net.quantize_for_serving(scales)
    want = _one_by_one(net, frames)
    server = InferenceServer(net, unroll=2)
    np.testing.assert_array_equal(server.predict(frames), want)
    assert stand_in.captures == 1
    captured = net._kernel_cache.quantized()
    assert len(captured) == len(scales)
    operands = [weakref.ref(t) for value in captured.values()
                for t in value]
    net.quantize_for_serving({k: 4.0 * v for k, v in scales.items()})
    _one_by_one(net, frames)
    replaced = net._kernel_cache.quantized()
    assert all(replaced[k] is not v for k, v in captured.items())
    del captured
    gc.collect()
    assert all(ref() is not None for ref in operands)
    np.testing.assert_array_equal(server.predict(frames), want)


def test_a_dropped_server_is_freed_without_a_collection(stand_in):
    """A server that has captured holds no reference cycle, so it and its
    graphs go as soon as it is dropped: a collection during a later
    capture (the collector runs at any allocation) would otherwise
    destroy a graph while a stream captures, which CUDA forbids."""
    import gc
    net = _fusion()
    server = InferenceServer(net, unroll=2)
    server.predict(_distinct(5))
    assert stand_in.captures == 1
    gone = weakref.ref(server)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del server
        assert gone() is None
    finally:
        if collecting:
            gc.enable()


def test_staging_set_is_not_rewritten_while_its_group_is_in_flight(
        stand_in, monkeypatch):
    """Each set is rewritten only after the event of the group that last
    read it: the stand-in sees no upload read a rewritten buffer, with
    the server's sets or with one set for all groups; it does see one
    once the wait for the event is taken out, so the check can fail."""
    from modular_semantic_segmentation_torch import serving
    frames = _distinct(9)
    net = _fusion()
    want = _one_by_one(net, frames)

    def served():
        stand_in.reused_in_flight = 0
        return InferenceServer(net, unroll=2, max_in_flight=3).predict(
            frames)

    np.testing.assert_array_equal(served(), want)
    assert stand_in.reused_in_flight == 0

    entry = serving.InferenceServer._entry

    def one_set(self, signature):
        made = entry(self, signature)
        made.staging = made.staging[:1]
        made.slot = 0
        return made
    monkeypatch.setattr(serving.InferenceServer, "_entry", one_set)
    np.testing.assert_array_equal(served(), want)
    assert stand_in.reused_in_flight == 0

    class Unwaited(serving._StagingSet):
        event = property(lambda self: None, lambda self, value: None)
        __slots__ = ()
    monkeypatch.setattr(serving, "_StagingSet", Unwaited)
    served()
    assert stand_in.reused_in_flight > 0


def _family(name, **config):
    rng = np.random.RandomState(4)
    pair = {"data_description": DATA_DESCRIPTION, "device": "cpu",
            "num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
            "prefixes": {"rgb": "rgb", "depth": "depth"}}
    single = {"data_description": DATA_DESCRIPTION, "device": "cpu",
              "num_units": 4, "prefix": "rgb", "modality": "rgb"}
    if name in ("simple_fcn", "bayesian_fcn"):
        base = dict(single, channel_factor=0.125)
    elif name == "adapnet":
        base = {"data_description": DATA_DESCRIPTION, "device": "cpu",
                "num_units": 4, "modality": "rgb"}
    elif name == "fusion_fcn":
        base = {"data_description": DATA_DESCRIPTION, "device": "cpu",
                "num_units": 4, "prefixes": {"rgb": "rgb", "depth": "depth"}}
    elif name == "progressive_fcn":
        base = {"data_description": DATA_DESCRIPTION, "device": "cpu",
                "num_units": 4, "prefix": "depth", "modality": "depth",
                "lateral_columns": {"rgb": "rgb"}}
    else:
        base = pair
    if name == "bayes_mix":
        base["confusion_matrices"] = {
            m: rng.rand(NUM_CLASSES, NUM_CLASSES) + np.eye(NUM_CLASSES) * 5
            for m in ("rgb", "depth")}
    if name in ("dirichlet_mix", "uncertainty_dirichlet_mix"):
        params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
                  for m in ("rgb", "depth")}
        params["class_counts"] = rng.randint(100, 1000, NUM_CLASSES)
        base["dirichlet_params"] = params
    return get_model(name)(**dict(base, **config))


@pytest.mark.parametrize("name,config,eager", [
    ("simple_fcn", {}, False),
    ("adapnet", {}, False),
    ("fusion_fcn", {}, False),
    ("progressive_fcn", {}, False),
    ("bayes_mix", {}, False),
    ("bayes_mix", {"use_decision_matrix": True}, False),
    ("average", {}, False),
    ("dirichlet_mix", {"use_pallas": True}, False),
    ("dirichlet_mix", {}, True),
    ("variance", {"dropout_rate": 0.0, "num_samples": 3}, False),
    ("variance", {"dropout_rate": 0.5, "num_samples": 1}, False),
    ("variance", {"dropout_rate": 0.5, "num_samples": 3}, True),
    ("bayesian_fcn", {"dropout_rate": 0.0, "num_samples": 2}, False),
    ("bayesian_fcn", {"dropout_rate": 0.5, "num_samples": 2}, True),
    ("uncertainty_dirichlet_mix", {"dropout_rate": 0.2, "num_samples": 2},
     True),
])
def test_families_take_the_path_their_forward_allows(stand_in, name, config,
                                                     eager):
    """The families whose forward draws from the model's generator or
    copies host arrays to the device are served eagerly and never
    captured; the others are captured, and serve the eager labels."""
    from modular_semantic_segmentation_torch import serving
    net = _family(name, **config)
    assert (serving.eager_reason(net) is not None) == eager
    frames = _distinct(5)
    if name in ("simple_fcn", "adapnet", "bayesian_fcn"):
        frames = [{"rgb": f["rgb"]} for f in frames]
    elif name == "progressive_fcn":
        frames = [{"rgb": f["rgb"], "depth": f["depth"]} for f in frames]
    state = net._generator.get_state()
    got = InferenceServer(net, unroll=1).predict(frames)
    assert stand_in.captures == (0 if eager else 1)
    assert stand_in.replays == (0 if eager else len(frames) - 1)
    net._generator.set_state(state)
    np.testing.assert_array_equal(got, _one_by_one(net, frames))


def test_a_distributed_model_is_served_eagerly(stand_in):
    """A model distributed over a mesh is served eagerly, and so is a
    group whose frames differ in shape."""
    from modular_semantic_segmentation_torch import serving
    net = _fusion()
    net._parallel = object()
    assert "mesh" in serving.eager_reason(net)
    net._parallel = None
    mixed = _distinct(1) + _distinct(1, shape=(64, 32))
    served = InferenceServer(net, unroll=2).predict_stream(mixed)
    for got, frame in zip(served, mixed):
        np.testing.assert_array_equal(got, _one_by_one(net, [frame])[0])
    assert stand_in.warms == stand_in.captures == 0
