"""The per-layer metrics read from the program's own spans and counters
(``benchmark/layer_metrics/program_spans.py``): each is found by name,
reads the program's snapshot with the arithmetic its file states, and
reads nothing (None) from an empty snapshot or a program without a
tracer. On the CPU: a tiny Bayes-fused SimpleFCN served and a tiny
SimpleFCN trained under a CPU profiler fill the snapshot; the CPU has no
stream time, so the stream metrics are held on a snapshot written out."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.registry import Registry
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.serving import InferenceServer
from modular_semantic_segmentation_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

# name: (cell, layer, what the reader sums, its key, its counter); every
# one's source is the program's spans
METRICS = {
    "serve_host_ms_per_frame.stream": (
        "fcn_rgbd.stream", "serving loop",
        ("serve.upload", "serve.launch", "serve.readback"), "host_s",
        "serve.frames"),
    "expert_stream_ms_per_frame.stream": (
        "fcn_rgbd.stream", "expert CNN",
        ("fusion.stems", "fusion.expert.rgb", "fusion.expert.depth"),
        "stream_s", "serve.frames"),
    "fusion_stream_ms_per_frame.stream": (
        "fcn_rgbd.stream", "fusion model", ("fusion.epilogue",),
        "stream_s", "serve.frames"),
    "serve_host_ms_per_frame.camera": (
        "fcn_rgbd.camera30", "serving loop",
        ("serve.upload", "serve.launch", "serve.readback"), "host_s",
        "serve.frames"),
    "serve_wait_ms_per_frame.camera": (
        "fcn_rgbd.camera30", "serving loop", ("serve.wait",), "host_s",
        "serve.frames_read"),
    "batch_wait_ms_per_step.train": (
        "fcn_rgbd.train", "training", ("fit.next_batch",), "host_s",
        "fit.steps"),
    "optimizer_stream_ms_per_step.train": (
        "fcn_rgbd.train", "training", ("fit.optimizer",), "stream_s",
        "fit.steps"),
}
HOST = [name for name, m in METRICS.items() if m[3] == "host_s"]
NUM_CLASSES = 6


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _serve_and_train():
    """Five frames at unroll 2 (a padded tail) and two ``fit`` steps, all
    under a CPU profiler."""
    description = (
        {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
        {"rgb": (None, None, 3), "depth": (None, None, 1),
         "labels": (None, None)}, NUM_CLASSES)
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) + 5 * np.eye(NUM_CLASSES)
           for m in ("rgb", "depth")}
    fusion = get_model("bayes_mix")(
        data_description=description, confusion_matrices=cms, device="cpu",
        num_units=4, channel_factor=0.125, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"})
    frames = [{"rgb": (rng.rand(32, 48, 3) * 255).astype(np.float32),
               "depth": rng.rand(32, 48, 1).astype(np.float32)}
              for _ in range(5)]
    trainer = get_model("simple_fcn")(
        prefix="rgb", modality="rgb", data_description=description,
        num_units=4, channel_factor=0.125, batchsize=2, loader_workers=1,
        device="cpu")
    data = {"rgb": (rng.rand(4, 32, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(0, NUM_CLASSES, (4, 32, 32)).astype(
                np.int32)}
    with profile(activities=[ProfilerActivity.CPU]):
        InferenceServer(fusion, unroll=2).predict(frames)
        trainer.fit(data, 2)


def _want(snap, name):
    _, _, spans, key, counter = METRICS[name]
    total = sum(snap["spans"][s][key] for s in spans if s in snap["spans"])
    return 1e3 * total / snap["counters"][counter]


def test_the_eight_metrics_are_declared_and_found():
    registry = Registry()
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    for name, (cell, layer, _, _, _) in METRICS.items():
        entry = declared[name]
        assert (entry["unit"], entry["better"], entry["source"],
                entry["layer"], entry["workloads"]) == (
                    "ms", "lower", "program_span", layer, [cell])
        moves = {m["name"] for m in registry.cell_metrics(cell,
                                                           "end_to_end")}
        assert entry["moves"] in moves - {"setup_s"}
        assert name in {m["name"] for m in registry.cell_metrics(
            cell, "per_layer")}
        assert callable(registry.reader(name))
    # appended after the accepted metrics, which keep their order
    assert [m["name"] for m in SPEC["per_layer"][-len(METRICS):]] == list(
        METRICS)


def test_host_metrics_read_the_programs_snapshot():
    _serve_and_train()
    snap = tracing.snapshot()
    assert snap["counters"]["serve.frames"] == 5
    assert snap["counters"]["serve.frames_read"] == 5
    assert snap["counters"]["fit.steps"] == 2
    registry = Registry()
    for name in HOST:
        got = registry.reader(name)(None)
        assert got == pytest.approx(_want(snap, name), rel=1e-12), name
        assert got > 0
    # the CPU records no stream time: the stream metrics read nothing
    for name in set(METRICS) - set(HOST):
        assert registry.reader(name)(None) is None, name


def test_device_metrics_read_the_stream_time(monkeypatch):
    snap = {"spans": {}, "counters": {"serve.frames": 48,
                                      "serve.frames_read": 44,
                                      "fit.steps": 4}}
    for i, name in enumerate(sorted({s for m in METRICS.values()
                                     for s in m[2]})):
        snap["spans"][name] = {"calls": 1, "host_s": 0.01 * (i + 1),
                               "self_host_s": 0.001,
                               "stream_s": 0.02 * (i + 1)}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    registry = Registry()
    for name in METRICS:
        assert registry.reader(name)(None) == pytest.approx(
            _want(snap, name), rel=1e-12), name
    expert = registry.reader("expert_stream_ms_per_frame.stream")(None)
    assert expert == pytest.approx(1e3 * sum(
        snap["spans"][s]["stream_s"] for s in (
            "fusion.stems", "fusion.expert.rgb", "fusion.expert.depth"))
        / 48)


def test_empty_snapshot_reads_nothing():
    registry = Registry()
    for name in METRICS:
        assert registry.reader(name)(None) is None, name


def test_a_program_without_a_tracer_reads_nothing(monkeypatch):
    _serve_and_train()
    monkeypatch.setitem(sys.modules,
                        "modular_semantic_segmentation_torch.utils.tracing",
                        None)
    monkeypatch.delattr("modular_semantic_segmentation_torch.utils.tracing",
                        raising=False)
    registry = Registry()
    for name in METRICS:
        assert registry.reader(name)(None) is None, name
