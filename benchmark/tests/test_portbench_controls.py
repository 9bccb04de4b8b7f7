"""On the card, at each cell's own size: the controls, and the planted
faults, come out not correct against the cell's limits on three seeds.

* served cells: the program with its int8 path switched on
  (``controls.py --control``), and an answer altered where it is
  produced;
* the training cell: the reference with TF32 on in the program's place,
  a step on half of its batch, and a step that leaves the variables as
  they were.

Run on a machine with a card:

    python -m pytest -m gpu benchmark/tests/test_portbench_controls.py
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark.controls import readings

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "workloads" /
                       f"{cell}.json").read_text())["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,mode", [
    ("fcn_rgbd.stream", "control"), ("fcn_rgbd.stream", "altered_answer"),
    ("fcn_rgbd.camera30", "control"), ("fcn_rgbd.camera30", "altered_answer"),
    ("fcn_rgbd.train", "control"), ("fcn_rgbd.train", "half_batch"),
    ("fcn_rgbd.train", "frozen_variables")])
def test_controls_and_faults_fail_a_limit(cell, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = _limits(cell)
    for seed in SEEDS:
        values = readings(cell, seed, mode, seconds=2.0)
        assert any(values[name] > limit for name, limit in limits.items()), \
            (seed, values, limits)
