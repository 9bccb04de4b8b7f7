"""The port's tracer (``utils/tracing.py``) and its spans and counters in
the serving loop, the fusion model, ``fit`` and the layers, on the CPU.

Off (no profiler recording) nothing is recorded and nothing of the
tracer runs; on (under ``torch.profiler.profile``) each span lies in the
profiler's trace as an ``mss.*`` range and in the tracer's records, with
its parent and its request id, and the counters count what the loop
moved. A tiny Bayes-fused SimpleFCN (32x48 frames, ``num_units`` 4,
``channel_factor`` 0.125) and a tiny SimpleFCN trained 2 steps.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.serving import (InferenceServer,
                                                         export_serving)
from modular_semantic_segmentation_torch.utils import tracing

NUM_CLASSES = 6
DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
CONFIG = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
          "prefixes": {"rgb": "rgb", "depth": "depth"}}
SERVE_SPANS = ("serve.upload", "serve.launch", "serve.readback")


def _fusion():
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    return get_model("bayes_mix")(data_description=DESCRIPTION,
                                  confusion_matrices=cms, device="cpu",
                                  **CONFIG)


def _frames(n=5):
    rng = np.random.RandomState(1)
    return [{"rgb": (rng.rand(32, 48, 3) * 255).astype(np.float32),
             "depth": rng.rand(32, 48, 1).astype(np.float32)}
            for _ in range(n)]


def _trainer():
    description = ({"labels": np.int32, "rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)},
                   NUM_CLASSES)
    return get_model("simple_fcn")(
        prefix="rgb", modality="rgb", data_description=description,
        num_units=4, channel_factor=0.125, batchsize=2, loader_workers=1,
        device="cpu")


def _train_data():
    rng = np.random.RandomState(2)
    return {"rgb": (rng.rand(4, 32, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(0, NUM_CLASSES, (4, 32, 32)).astype(
                np.int32)}


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_path_runs_nothing_of_the_tracer(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer ran while no profiler recorded")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_cuda_event", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    labels = InferenceServer(_fusion(), unroll=2).predict(_frames())
    assert labels.shape == (5, 32, 48)
    net = _trainer()
    net.fit(_train_data(), 2)
    assert net.global_step == 2
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    assert tracing.records() == []
    assert tracing.span("x") is tracing.span("y")


def test_serving_spans_share_the_group_id_and_nest_the_fusion():
    server = InferenceServer(_fusion(), unroll=2)
    frames = _frames()
    with _recording():
        labels = server.predict(frames)
    assert labels.shape == (5, 32, 48)
    records = tracing.records()
    names = _by_name(records)
    # 5 frames at unroll 2: three groups, the last padded by one frame
    for name in SERVE_SPANS + ("serve.wait",):
        assert len(names[name]) == 3, name
    groups = [r["request"] for r in names["serve.upload"]]
    assert len(set(groups)) == 3 and None not in groups
    for name in SERVE_SPANS + ("serve.wait",):
        assert [r["request"] for r in names[name]] == groups, name
    launches = {r["id"]: r for r in names["serve.launch"]}
    # each group's two frames: the packed stems, each expert, the epilogue
    for name in ("fusion.stems", "fusion.expert.rgb", "fusion.expert.depth",
                 "fusion.epilogue"):
        assert len(names[name]) == 6, name
        for r in names[name]:
            parent = launches[r["parent"]]
            assert r["request"] == parent["request"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= parent["end_ns"]
    counters = tracing.snapshot()["counters"]
    assert counters["serve.frames"] == 5
    assert counters["serve.frames_read"] == 5
    assert counters["serve.padded_frames"] == 1
    frame_bytes = sum(v.nbytes for v in frames[0].values())
    assert counters["serve.upload_bytes"] == 6 * frame_bytes
    assert counters["serve.readback_bytes"] == 5 * labels[0].nbytes
    spans = tracing.snapshot()["spans"]
    # the CPU records no stream time
    assert spans["serve.launch"]["stream_s"] is None
    assert spans["serve.launch"]["calls"] == 3


def test_self_time_is_duration_less_the_children():
    with _recording():
        InferenceServer(_fusion(), unroll=2).predict(_frames(4))
    records = tracing.records()
    children = {}
    for r in records:
        if r["parent"] is not None:
            children[r["parent"]] = (children.get(r["parent"], 0)
                                     + r["end_ns"] - r["start_ns"])
    want = {}
    for r in records:
        own = r["end_ns"] - r["start_ns"] - children.get(r["id"], 0)
        total = want.setdefault(r["name"], [0, 0])
        total[0] += r["end_ns"] - r["start_ns"]
        total[1] += own
    spans = tracing.snapshot()["spans"]
    assert set(spans) == set(want)
    for name, (host_ns, own_ns) in want.items():
        assert spans[name]["host_s"] == pytest.approx(1e-9 * host_ns,
                                                      rel=1e-12)
        assert spans[name]["self_host_s"] == pytest.approx(1e-9 * own_ns,
                                                           rel=1e-12)
    launch = spans["serve.launch"]
    assert 0 < launch["self_host_s"] < launch["host_s"]


def test_spans_lie_on_the_profilers_clock(tmp_path):
    with _recording() as prof:
        InferenceServer(_fusion(), unroll=2).predict(_frames(4))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "mss.serve.launch"]
    assert len(ranges) == 2
    convs = [e["ts"] for e in events if e["name"] == "aten::conv2d"]
    assert convs
    for lo, hi in ranges:
        assert any(lo <= t <= hi for t in convs)
    inside = sum(any(lo <= t <= hi for lo, hi in ranges) for t in convs)
    assert inside == len(convs)
    names = {e["name"] for e in events}
    assert {"mss.serve.upload", "mss.serve.readback", "mss.serve.wait",
            "mss.fusion.expert.rgb", "mss.fusion.epilogue"} <= names


def test_fit_spans_count_once_per_step():
    net = _trainer()
    with _recording():
        net.fit(_train_data(), 2)
    spans = tracing.snapshot()["spans"]
    for name in ("fit.next_batch", "fit.step", "fit.forward_backward",
                 "fit.optimizer"):
        assert spans[name]["calls"] == 2, name
    assert tracing.snapshot()["counters"]["fit.steps"] == 2
    names = _by_name(tracing.records())
    assert [r["request"] for r in names["fit.next_batch"]] == [0, 1]
    steps = {r["id"]: r for r in names["fit.step"]}
    assert [r["request"] for r in steps.values()] == [0, 1]
    for name in ("fit.forward_backward", "fit.optimizer"):
        for r in names[name]:
            assert r["request"] == steps[r["parent"]]["request"]
    # the producer thread ran beside the steps; the main thread traced
    threads = {r["thread"] for r in tracing.records()}
    assert threads == {threading.get_ident()}


def test_spans_from_many_threads_keep_exact_totals():
    per_thread, workers = 200, 8
    barrier = threading.Barrier(workers)

    def work(k):
        barrier.wait(timeout=30)
        for i in range(per_thread):
            with tracing.span("outer", request=k):
                with tracing.span("inner"):
                    tracing.count("n")

    with _recording():
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["spans"]["outer"]["calls"] == workers * per_thread
    assert snap["spans"]["inner"]["calls"] == workers * per_thread
    assert snap["counters"]["n"] == workers * per_thread
    records = tracing.records()
    outer = {r["id"]: r for r in records if r["name"] == "outer"}
    for r in records:
        if r["name"] == "inner":
            parent = outer[r["parent"]]
            assert parent["thread"] == r["thread"]
            assert parent["request"] == r["request"]


def test_the_ring_drops_records_and_keeps_totals():
    small = tracing.Tracer(capacity=3)
    with _recording():
        for _ in range(5):
            with small.span("a"):
                pass
    assert len(small.records()) == 3
    snap = small.snapshot()
    assert snap["spans"]["a"]["calls"] == 5
    assert snap["counters"]["tracing.dropped"] == 2
    small.reset()
    assert small.snapshot() == {"spans": {}, "counters": {}}


def test_spans_and_counters_are_off_while_a_stream_captures(monkeypatch):
    """While this thread's CUDA stream captures a graph no span or counter
    records (a span's timing event would be captured into the graph);
    before CUDA is initialized no capture is asked for, so a build without
    CUDA records as it did."""
    tracer = tracing.Tracer()
    with _recording():
        assert not tracing._capturing()
        with tracer.span("before"):
            tracer.count("seen")
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert not tracing.active()
        assert tracer.span("inside") is tracing._OFF
        tracer.count("hidden")
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        assert tracing.active()
        with tracer.span("after"):
            pass
    snap = tracer.snapshot()
    assert set(snap["spans"]) == {"before", "after"}
    assert snap["counters"] == {"seen": 1}


@pytest.mark.parametrize("loop", ["serve", "fit"])
def test_kernel_cache_misses_only_on_the_first_frame(loop):
    """The kernel cache misses on a served model's first frame and on a
    trained model's first step, and not after: the kernels it checked are
    the same objects (a train step keeps the frozen variables), so a later
    frame or step waits for no check."""
    if loop == "serve":
        server = InferenceServer(_fusion(), unroll=1)
        frames = _frames(2)
        calls = [lambda: server.predict(frames[:1]),
                 lambda: server.predict(frames[1:])]
        counter = "serve.frames"
    else:
        net, data = _trainer(), _train_data()
        calls = [lambda: net.fit(data, 1)] * 2
        counter = "fit.steps"
    with _recording():
        calls[0]()
    first = tracing.snapshot()["counters"].get("layers.kernel_cache_miss", 0)
    assert first > 0
    tracing.reset()
    with _recording():
        calls[1]()
    counters = tracing.snapshot()["counters"]
    assert counters.get("layers.kernel_cache_miss", 0) == 0
    assert counters[counter] == 1


def test_exported_program_holds_no_profiler_op(tmp_path):
    net = _fusion()
    batch = {k: v[None] for k, v in _frames(1)[0].items()}
    with _recording():
        export_serving(net, str(tmp_path), batch)
    program = torch.export.load(str(tmp_path / "program.pt2"))
    targets = [str(node.target) for node in program.graph.nodes]
    assert not any("profiler" in t or "record_function" in t
                   for t in targets)
    # the export runs no eager forward, and its traced one records nothing
    assert "fusion.epilogue" not in tracing.snapshot()["spans"]
