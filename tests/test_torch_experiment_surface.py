"""The port's finetuning, train_and_evaluate_progressive, ibcc_fusion,
report and rerun CLIs against the JAX package's, on the CPU.

One experiment store. The port trains an rgb and a depth SimpleFCN (32x32
UnittestData, ``num_units`` 4, ``channel_factor`` 0.25, 2 steps), fuses
them with ``bayes_fusion``, finetunes the rgb run to depth
(``rgb_to_depth``, 0 steps, so the exported weights are the translated
ones), trains a FusionFCN (1 step) and from its rgb column, translated,
a progressive depth column with that column lateral (``rgb_to_depth``, 1
step). One
subprocess then runs the JAX package's ``evaluation`` of the port's
finetuned run and its ``ibcc_fusion`` of the two experts; the port runs
its own ``ibcc_fusion``, ``report`` and ``rerun``.

Held: the kernel surgery is exact (both spellings, against JAX's
functions; the finetuned run's first kernel is the mean of the rgb run's,
the progressive lateral column's too after its step); JAX's evaluation
reads the port's finetuned run, its confusion matrix equal to the port's
but at near ties (two best probabilities within 1e-5, at most two counts
a pixel, as tests/test_torch_experiments.py); the two ``predictions.npz``
hold the same keys and ground truth, the labels equal but at such near
ties; the quality table equals JAX's DataFrame within 1e-12, rows and
columns in the same order; a port record reruns to the same config and
measurements, and JAX's evaluation record runs through the port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import experiments.finetuning as jax_finetuning
import experiments.report as jax_report
import modular_semantic_segmentation_tpu.settings as jax_settings
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.experiments import (
    bayes_fusion, evaluation, finetuning, ibcc_fusion, report, rerun,
    train_and_evaluate_progressive, training)
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils import experiment as port_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = {"height": 32, "width": 32, "num_train": 6, "num_measure": 2,
        "num_test": 4}
EVAL_DATA = {"dataset": "unittest", **DATA}
NET = {"num_units": 4, "channel_factor": 0.25, "batchsize": 2,
       "learning_rate": 0.01}
TIE = 1e-5

# the JAX package's CLIs in one process; prints {key: run id}
JAX_CLIS = """
import json, sys
from experiments import evaluation, ibcc_fusion
ids = {}
for key, module, command, config in json.loads(sys.argv[1]):
    module = {"evaluation": evaluation, "ibcc_fusion": ibcc_fusion}[module]
    module.ex.run(command, config_updates=config)
    ids[key] = module.ex.current_run._id
print("RUN_IDS " + json.dumps(ids))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_run(module, config, command="main"):
    module.ex.run(command, config_updates=dict(config, device="cpu",
                                               seed=1))
    return module.ex.current_run._id


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    ids = {"store": store}
    with pytest.MonkeyPatch.context() as patch:
        for module in (settings, jax_settings):
            patch.setattr(module, "EXPERIMENT_STORAGE_FOLDER",
                          str(store / "experiments"))
            patch.setattr(module, "EXP_OUT", str(store / "exp"))
            patch.setattr(module, "EXPERIMENT_DB_HOST", None)
        for m in ("rgb", "depth"):
            ids[m] = _port_run(training, {
                "modelname": "simple_fcn", "num_iterations": 2,
                "starting_weights": False,
                "dataset": {"name": "unittest", **DATA},
                "net_config": dict(NET, prefix=m, modality=m)})
        weights = {m: ids[m] for m in ("rgb", "depth")}
        ids["bayes"] = _port_run(bayes_fusion, {
            "starting_weights": weights, "evaluation_data": EVAL_DATA,
            "net_config": dict(NET, expert_model="fcn",
                               prefixes={"rgb": "rgb", "depth": "depth"})})
        ids["finetuned"] = _port_run(finetuning, {
            "starting_weights": {"experiment_id": ids["rgb"]},
            "data_config": EVAL_DATA, "num_iterations": 0,
            "net_config": dict(NET, prefix="rgb", modality="depth")},
            command="rgb_to_depth")
        ids["columns"] = _port_run(training, {
            "modelname": "fusion_fcn", "num_iterations": 1,
            "starting_weights": False,
            "dataset": {"name": "unittest", **DATA},
            "net_config": dict(NET, prefixes={"rgb": "rgb",
                                              "depth": "depth"})})
        ids["progressive"] = _port_run(train_and_evaluate_progressive, {
            "starting_weights": {"experiment_id": ids["columns"]},
            "data_config": EVAL_DATA, "num_iterations": 1,
            "net_config": dict(NET, prefix="depth", modality="depth",
                               lateral_columns={"rgb": "depth"})},
            command="rgb_to_depth")
        ibcc = {"net_config": dict(NET, expert_model="fcn",
                                   prefixes={"rgb": "rgb", "depth": "depth"}),
                "dataset": {"name": "unittest", **DATA},
                "starting_weights": weights}
        jobs = [
            ("evaluation", "evaluation", "main", {
                "modelname": "simple_fcn", "seed": 1,
                "starting_weights": ids["finetuned"],
                "evaluation_data": EVAL_DATA,
                "net_config": dict(NET, prefix="rgb", modality="depth")}),
            ("ibcc", "ibcc_fusion", "main", dict(
                ibcc, seed=1, save_to=str(store / "ibcc_jax")))]
        result = subprocess.run(
            [sys.executable, "-c", JAX_CLIS, json.dumps(jobs)],
            capture_output=True, text=True, cwd=REPO, timeout=600,
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     EXPERIMENT_STORAGE_FOLDER=str(store / "experiments"),
                     EXP_OUT=str(store / "exp")))
        assert result.returncode == 0, result.stderr[-3000:]
        line = next(x for x in result.stdout.splitlines()
                    if x.startswith("RUN_IDS "))
        ids.update({f"jax {k}": v for k, v in json.loads(
            line[len("RUN_IDS "):]).items()})
        ids["port evaluation"] = _port_run(evaluation, jobs[0][3])
        _port_run(ibcc_fusion, dict(ibcc, save_to=str(store / "ibcc_port")))
        ids["rerun of rgb"] = _port_run(rerun, {"experiment_id": ids["rgb"]})
        ids["rerun of rgb, run"] = training.ex.current_run._id
        ids["rerun of jax evaluation"] = _port_run(
            rerun, {"experiment_id": ids["jax evaluation"]})
        ids["rerun of jax evaluation, run"] = evaluation.ex.current_run._id
        ids["quality"] = _port_run(report, {"experiments": {
            "bayes": ids["bayes"], "depth": ids["depth"]}})
        yield ids


def _record(run_id):
    return port_exp.ExperimentData(run_id).get_record()


def _weights(run_id):
    with np.load(port_exp.ExperimentData(run_id).get_weights()) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("spelling", ["{}/conv1_1/kernel",
                                      "{}_conv1_1/kernel"])
def test_kernel_surgery_matches_jax(spelling):
    rng = np.random.RandomState(0)
    for port_fn, jax_fn, prefix, channels in (
            (finetuning.translate_rgb_to_depth,
             jax_finetuning.translate_rgb_to_depth, "rgb", 3),
            (finetuning.translate_depth_to_rgb,
             jax_finetuning.translate_depth_to_rgb, "depth", 1)):
        key = spelling.format(prefix)
        weights = {key: rng.randn(3, 3, channels, 8).astype(np.float32),
                   "other": rng.randn(4).astype(np.float32)}
        got, want = port_fn(weights, prefix), jax_fn(weights, prefix)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got[key].shape[2] == 4 - channels


def test_finetuned_run_holds_the_translated_kernel(runs):
    source = _weights(runs["rgb"])
    got = _weights(runs["finetuned"])
    np.testing.assert_array_equal(
        got["rgb/conv1_1/kernel"],
        source["rgb/conv1_1/kernel"].mean(2, keepdims=True))
    loaded = finetuning._load_experiment_weights(
        {"experiment_id": runs["rgb"]})
    want = jax_finetuning._load_experiment_weights(
        {"experiment_id": runs["rgb"]})
    assert loaded.keys() == want.keys()
    assert all(np.array_equal(loaded[k], want[k]) for k in want)


def test_progressive_lateral_column_is_the_translated_column(runs):
    """The FusionFCN run's rgb column, its first kernel averaged to one
    channel, is the depth column's frozen lateral column after a step,
    while the new depth column trains."""
    source = _weights(runs["columns"])
    got = _weights(runs["progressive"])
    np.testing.assert_array_equal(
        got["rgb_conv1_1/kernel"],
        source["rgb_conv1_1/kernel"].mean(2, keepdims=True))
    for key in ("rgb_conv3_1/kernel", "rgb_conv5_3/bias"):
        np.testing.assert_array_equal(got[key], source[key])
    assert not np.array_equal(got["depth_conv1_1/kernel"],
                              source["depth_conv1_1/kernel"])


def _near_ties(prob):
    top = np.sort(prob, -1)
    return top[..., -1] - top[..., -2] <= TIE


def _confusion(run_id):
    return np.asarray(port_exp.reverse_convert_datatypes(
        _record(run_id)["info"]["confusion_matrix"]))


def test_jax_evaluation_reads_the_finetuned_run(runs):
    got = _confusion(runs["port evaluation"])
    want = _confusion(runs["jax evaluation"])
    data = get_dataset("unittest")(**DATA)
    net = get_model("simple_fcn")(
        data_description=data.get_data_description(), prefix="rgb",
        modality="depth", device="cpu", **NET)
    evaluation.import_weights_into_network(net, runs["finetuned"])
    ties = int(_near_ties(net.predict(data.get_testset(),
                                      output_attr="prob")).sum())
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() <= 2 * ties


def test_ibcc_predictions_match_jax(runs):
    store = runs["store"]
    with np.load(store / "ibcc_port" / "predictions.npz") as a, \
            np.load(store / "ibcc_jax" / "predictions.npz") as b:
        got, want = dict(a), dict(b)
    assert sorted(got) == sorted(want) == sorted(
        [f"{s}_{m}" for s in ("measure", "test")
         for m in ("rgb", "depth", "gt")])
    for key in ("measure_gt", "test_gt"):
        np.testing.assert_array_equal(got[key], want[key])
    data = get_dataset("unittest")(**DATA)
    for m in ("rgb", "depth"):
        net = get_model("simple_fcn")(
            data_description=data.get_data_description(), prefix=m,
            modality=m, device="cpu", **NET)
        evaluation.import_weights_into_network(net, runs[m])
        for split, source in (("measure", data.get_measureset()),
                              ("test", data.get_testset())):
            key = f"{split}_{m}"
            assert got[key].dtype == want[key].dtype == np.int32
            differ = got[key] != want[key]
            ties = _near_ties(net.predict(source, output_attr="prob"))
            assert not (differ & ~ties).any()


def test_quality_table_matches_jax(runs):
    experiments = {"bayes": runs["bayes"], "depth": runs["depth"]}
    got = report.build_quality_table(experiments)
    want = jax_report.build_quality_table(experiments)
    assert got.index == list(want.index)
    assert got.columns == list(want.columns) == ["Bayes", "RGB", "Depth"]
    np.testing.assert_allclose(got.values, want.values.astype(np.float64),
                               rtol=0, atol=1e-12)
    names = report._resolve_class_names(experiments, None)
    assert names == jax_report._resolve_class_names(experiments, None)
    info = _record(runs["quality"])["info"]
    assert set(info["table"]) == {"Bayes", "RGB", "Depth"}
    assert list(info["table"]["Bayes"]) == ["mean"] + names


def test_rerun_of_a_port_record(runs):
    old, new = _record(runs["rgb"]), _record(runs["rerun of rgb, run"])
    assert new["config"] == old["config"]
    assert new["experiment"]["mainfile"] == "training.py"
    assert (new["info"]["measurements"]["mean_IoU"]
            == old["info"]["measurements"]["mean_IoU"])


def test_rerun_of_a_jax_record_runs_through_the_port(runs):
    old = _record(runs["jax evaluation"])
    new = _record(runs["rerun of jax evaluation, run"])
    assert new["config"] == dict(old["config"], device="cpu")
    np.testing.assert_array_equal(
        _confusion(runs["rerun of jax evaluation, run"]),
        _confusion(runs["port evaluation"]))
