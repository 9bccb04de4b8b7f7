"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric added as files are found by name and run; a
malformed name is refused; ``BENCHMARK.json`` agrees with the files.
Runs here are tiny and on the CPU: the harness's look for a card is
skipped, nothing else."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness.registry import NAME, Registry
from benchmark.harness.runner import run_cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

# a tiny frame and a short window: the CPU runs the full widths
TINY = {"config": {"serve": {"height": 64, "width": 32},
                   "train": {"height": 48, "width": 64, "batch": 2}},
        "traffic": {"pool_frames": 8, "warmup_frames": 4,
                    "checked_frames": 3, "chunk_steps": 2,
                    "checked_steps": 3, "warmup_steps": 1,
                    "trace_steps": 1}}


def test_benchmark_json_agrees_with_the_files():
    registry = Registry()
    for entry in SPEC["workloads"]:
        cell = registry.workload(entry["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == entry[key], (entry["name"], key)
        registry.family(registry.config(cell["config"]))
        registry.client(registry.traffic(cell["traffic"]))
    for entry in SPEC["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"]
    for metric in SPEC["per_layer"]:
        assert callable(registry.reader(metric["name"]))
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("name", ["bad name", "../configs/x", "a/b", "",
                                  ".hidden", "x" * 65, "a,b"])
def test_malformed_names_are_refused(name):
    registry = Registry()
    for find in (registry.workload, registry.config, registry.traffic,
                 registry.reader):
        with pytest.raises(ValueError):
            find(name)


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        Registry().workload("no_such_cell")


def test_parts_added_as_files_are_found_and_run(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file of its own in a copy of the folder, run without any edit."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    config = json.loads((bench / "configs" / "fcn_rgbd.json").read_text())
    config["num_classes"] = 5
    (bench / "configs" / "fcn_small.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "stream.json").read_text())
    traffic["unroll"] = 2
    (bench / "traffic" / "stream2.json").write_text(json.dumps(traffic))
    cell = {"config": "fcn_small", "traffic": "stream2", "chips": 1,
            "why": "a test cell", "checks": {"label_gap": 1.0}}
    (bench / "workloads" / "fcn_small.stream2.json").write_text(
        json.dumps(cell))
    (bench / "layer_metrics" / "frames_seen.stream2.py").write_text(
        "def read(obs):\n    return float(obs.window['units'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(dict(name="fcn_small.stream2", **{
        k: cell[k] for k in ("config", "traffic", "chips", "why")}))
    spec["end_to_end"][0]["workloads"].append("fcn_small.stream2")
    spec["per_layer"].append({"name": "frames_seen.stream2", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "traffic", "moves": "serve_fps",
                              "workloads": ["fcn_small.stream2"]})
    registry = Registry(bench, spec)
    result = run_cell("fcn_small.stream2", 2**31 + 11, 0.3, False,
                      device="cpu", registry=registry, overrides=TINY)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"serve_fps", "setup_s"}
    assert result["failed"] == 0
    assert result["attempted"] % 2 == 0
    metrics = registry.cell_metrics("fcn_small.stream2", "per_layer")
    assert [m["name"] for m in metrics] == ["frames_seen.stream2"]
    assert registry.reader("frames_seen.stream2")(
        type("Obs", (), {"window": {"units": 6}})) == 6.0


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_runs_and_is_correct_on_the_cpu(cell):
    result = run_cell(cell, 2**31 + 5, 0.3, False, device="cpu",
                      overrides=TINY)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in Registry().cell_metrics(cell, "end_to_end")}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
