"""``fit``'s files against the JAX package's, on the CPU: the event file,
``summaries.jsonl``, ``checkpoint.pkl`` (written by one package, resumed by
the other with identical variables, step and optimizer leaves) and the npz
route of ``load_weights``.

Small SimpleFCN models (32x32 frames, ``num_units=4``, the full VGG16
depth at ``channel_factor=0.25``). Equalities are exact: a checkpoint
carries float32 and int32 arrays unchanged, and the event files are
compared byte for byte.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.utils import tfevents as jax_tfevents
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.ops import optimizers
from modular_semantic_segmentation_torch.utils import tfevents

NUM_CLASSES = 5
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)
SMALL = {"prefix": "rgb", "modality": "rgb",
         "data_description": DATA_DESCRIPTION, "num_units": 4,
         "channel_factor": 0.25, "batchsize": 2, "learning_rate": 0.01}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, item 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed, n=4):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 32)).astype(np.int32)}


def _leaves(net):
    return [x.numpy() for x in optimizers.state_leaves(net._optimizer,
                                                       net.opt_state)]


def test_event_file_is_byte_equal_to_jax(tmp_path):
    records = [(1, {"loss": 1.25, "accuracy": 0.5, "IoU": 0.125}),
               (300, {"loss": 0.1, "IoU": 2.0 ** -20}),
               (2 ** 40, {"extra/set": -3.5})]
    paths = []
    for package, module in (("port", tfevents), ("jax", jax_tfevents)):
        logdir = tmp_path / package
        logdir.mkdir()
        with module.EventWriter(str(logdir), wall_time=1.5e9) as writer:
            for i, (step, scalars) in enumerate(records):
                writer.add_scalars(step, scalars, wall_time=1.5e9 + i)
        paths.append(writer.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    events = list(jax_tfevents.iter_scalar_events(paths[0]))
    assert [(e.step, e.tag) for e in events] == [
        (step, tag) for step, scalars in records for tag in scalars]
    assert [e.simple_value for e in events] == [
        float(np.float32(v)) for _, s in records for v in s.values()]


def test_fit_writes_summaries_events_and_checkpoints(tmp_path):
    """Validation at steps 0 and 2 of 4 (interval 2), with an extra data
    set; a checkpoint every 3 steps; the event file holds the records'
    scalars."""
    net = get_model("simple_fcn")(device="cpu", output_dir=str(tmp_path),
                                  checkpoint_interval=3, **SMALL)
    net.fit(_data(0), 4, validation_dataset=_data(1, n=2),
            validation_interval=2,
            additional_eval_datasets={"extra": _data(2, n=2)})
    with open(tmp_path / "summaries.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 3]
    for r in records:
        assert sorted(r) == ["IoU", "accuracy", "extra", "loss", "step",
                             "wall_time"]
        assert np.isfinite([r[k] for k in r]).all()
    event_files = [p for p in os.listdir(tmp_path)
                   if p.startswith("events.out.tfevents.")]
    assert len(event_files) == 1
    events = list(jax_tfevents.iter_scalar_events(
        str(tmp_path / event_files[0])))
    assert [(e.step, e.tag) for e in events] == [
        (r["step"], tag) for r in records
        for tag in ("loss", "accuracy", "IoU", "extra")]
    for e in events:
        record = next(r for r in records if r["step"] == e.step)
        assert e.simple_value == float(np.float32(record[e.tag]))
    # the checkpoint of step 3
    resumed = get_model("simple_fcn")(device="cpu", **SMALL)
    resumed.load_weights(str(tmp_path / "checkpoint.pkl"))
    assert resumed.global_step == 3
    assert int(resumed.opt_state["count"]) == 3


def test_abort_at_iou_ends_the_fit():
    net = get_model("simple_fcn")(device="cpu", abort_at_iou=-1.0, **SMALL)
    net.fit(_data(3), 5, validation_dataset=_data(4, n=2), output=False)
    assert net.global_step == 1


@pytest.mark.parametrize("trainer", ["adam", "adagrad", "rmsprop"])
def test_port_checkpoint_resumes_in_jax(tmp_path, trainer):
    net = get_model("simple_fcn")(device="cpu", output_dir=str(tmp_path),
                                  checkpoint_interval=2, trainer=trainer,
                                  **SMALL)
    net.fit(_data(5), 2, output=False)
    jnet = jax_model("simple_fcn")(trainer=trainer, **SMALL)
    jnet.load_weights(str(tmp_path / "checkpoint.pkl"))
    assert jnet.global_step == net.global_step == 2
    assert sorted(jnet.variables) == sorted(net.variables)
    for k, v in net.variables.items():
        np.testing.assert_array_equal(np.asarray(jnet.variables[k]),
                                      v.numpy(), err_msg=k)
    jleaves = jax.tree_util.tree_flatten(jnet.opt_state)[0]
    leaves = _leaves(net)
    assert len(jleaves) == len(leaves)
    for got, want in zip(jleaves, leaves):
        got = np.asarray(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trainer", ["adam", "adagrad", "rmsprop"])
def test_jax_checkpoint_resumes_in_port(tmp_path, trainer):
    jnet = jax_model("simple_fcn")(trainer=trainer, **SMALL)
    rng = np.random.RandomState(6)
    jnet.variables = {k: (np.asarray(v) + rng.randn(*v.shape) * 0.01
                          ).astype(np.float32)
                      for k, v in jnet.variables.items()}
    leaves, treedef = jax.tree_util.tree_flatten(jnet.opt_state)
    leaves = [np.asarray(x) + (7 if x.dtype == np.int32 else
                               rng.rand(*x.shape).astype(np.float32))
              for x in leaves]
    jnet.opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    jnet.global_step = 7
    path = jnet.save_checkpoint(str(tmp_path / "checkpoint.pkl"))
    net = get_model("simple_fcn")(device="cpu", trainer=trainer, **SMALL)
    net.load_weights(path)
    assert net.global_step == 7
    for k, v in jnet.variables.items():
        np.testing.assert_array_equal(net.variables[k].numpy(), v,
                                      err_msg=k)
    got = _leaves(net)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and training goes on from there
    net.fit(_data(7), 1, output=False)
    assert net.global_step == 8


def test_load_weights_takes_npz_through_import_weights(tmp_path):
    source = get_model("simple_fcn")(device="cpu", seed=3, **SMALL)
    path = source.export_weights(save_dir=str(tmp_path))
    net = get_model("simple_fcn")(device="cpu", **SMALL)
    net.load_weights(path)
    for k, v in source.variables.items():
        assert torch.equal(net.variables[k], v), k
    assert net.global_step == 0
