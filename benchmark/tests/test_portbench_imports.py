"""What the benchmark loads: nothing whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or the JAX package (the port's name
begins with the JAX package's, so a prefix test would be wrong either
way); and the reference loads nothing of the port. Each in a fresh
process."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "modular_semantic_segmentation_tpu"}

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark.harness import (compare, devtrace, frames, peaks, readers,
                               registry, runner, serving, timing, weights)
import benchmark.controls
reg = registry.Registry()
for cell in reg.spec["workloads"]:
    c = reg.workload(cell["name"])
    reg.family(reg.config(c["config"]))
    reg.client(reg.traffic(c["traffic"]))
for metric in reg.spec["per_layer"]:
    reg.reader(metric["name"])
import modular_semantic_segmentation_torch.models.bayes_fusion
import modular_semantic_segmentation_torch.models.adapnet
import modular_semantic_segmentation_torch.serving
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference import adapnet, bayes, layers, train, vgg_fcn
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    loaded = _top_level(HARNESS)
    assert "modular_semantic_segmentation_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(REFERENCE)
    assert "torch" in loaded
    assert "modular_semantic_segmentation_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "fcn_rgbd.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
