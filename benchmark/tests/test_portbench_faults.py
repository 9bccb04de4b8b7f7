"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, with each fault the cell can have planted in the
program before its first frame or step.

* served cells: an answer altered where it is produced (a block of each
  fused frame's labels moved to the next class);
* the training cell: a step that returns its state unchanged, a step
  that advances the optimizer's state but returns the variables it was
  given, and a step on half of its batch (the mean taken over the rest).

A serving cell has batch 1 and one card, so it has no half batch and no
exchange between cards to leave out; nor has the training cell, on one
card, an exchange.
"""

import pytest

from benchmark.controls import FAULTS
from benchmark.harness.runner import run_cell
from benchmark.tests.test_portbench_harness import TINY


def _unchanged(client):
    def step(variables, opt_state, batch):
        loss = client.net.__class__._train_step(client.net, variables,
                                                opt_state, batch)[2]
        return variables, opt_state, loss

    client.net._train_step = step


@pytest.mark.parametrize("cell,fault", [
    ("fcn_rgbd.stream", FAULTS["altered_answer"]),
    ("fcn_rgbd.camera30", FAULTS["altered_answer"]),
    ("fcn_rgbd.train", _unchanged),
    ("fcn_rgbd.train", FAULTS["frozen_variables"]),
    ("fcn_rgbd.train", FAULTS["half_batch"]),
], ids=["stream-altered", "camera-altered",
        "train-unchanged", "train-frozen-variables", "train-half-batch"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = run_cell(cell, 2**31 + 3, 0.3, False, device="cpu",
                      overrides=TINY, program_hook=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
