"""The port's uncertainty benchmarks (``experiments/uncertainty_eval.py``)
against the JAX package's, on the CPU.

One BayesianFCN (rgb, ``num_units`` 4, ``channel_factor`` 0.25, 2 samples
at dropout 0, so that the two packages' different dropout masks do not
enter) with JAX's initial weights, saved as an npz that both packages'
CLIs import. A subprocess runs the JAX package's commands into a store of
its own while the port runs the same in-process into another, on 32x32
UnittestData (4 classes) and, for the out-of-distribution benchmark, on
``add_random_objects`` over it with an object library written into a
temporary DATA_BASEPATH (full-size objects: exact in both packages):
``uncertainty_benchmark`` (misclassification: entropy and variance;
out_of_distribution: entropy), ``measure``, ``uncertainty_parameter_search``
over ``num_samples`` and ``train_ambiguous`` (flip_classes, one step);
then JAX's ``evaluate_temperature_scaling`` of its ambiguous run, and the
port's of the same run.

Held: the NLL, the value distributions' means, spreads and bin edges, the
Dirichlet fitted to the outputs and the mean output within 1e-5 of their
scale; the class counts equal, the histogram counts within 0.1% of the
values (a value within 1e-5 of a bin edge may land in the next bin);
AUROC within 1e-4; ``train_ambiguous`` records
JAX's flip classes and probability for the same seed.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
import modular_semantic_segmentation_tpu.settings as jax_settings
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import image_io
from modular_semantic_segmentation_torch.experiments import uncertainty_eval
from modular_semantic_segmentation_torch.utils import experiment as port_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = {"name": "unittest", "height": 32, "width": 32, "num_train": 6,
        "num_measure": 2, "num_test": 4}
OOD_DATA = dict(DATA, name="add_random_objects", add_to_dataset="unittest",
                halfsize=False, num_classes=4)
NET = {"prefix": "rgb", "modality": "rgb", "num_units": 4,
       "channel_factor": 0.25, "batchsize": 2, "num_samples": 2,
       "dropout_rate": 0.0}
RTOL = 1e-5
AUROC_ATOL = 1e-4
TEMPERATURES = [0.5, 1.0, 2.0]

# the JAX package's commands in one process; prints {key: [run id, info]}
JAX_RUNS = """
import json, sys
from experiments import uncertainty_eval as ue
from modular_semantic_segmentation_tpu.utils.experiment import ExperimentData
out = {}
for key, command, config in json.loads(sys.argv[1]):
    if command == "evaluate_temperature_scaling":
        config["experiments"] = [out["train_ambiguous"][0]]
    ue.ex.run(command, config_updates=config)
    out[key] = [ue.ex.current_run._id, ue.ex.current_run.info]
out["ambiguous record"] = [None, ExperimentData(
    out["train_ambiguous"][0]).get_record()["info"]]
print("RUNS " + json.dumps(out, default=lambda o: o.tolist()))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_library(base):
    rng = np.random.RandomState(2)
    for num in range(251, 257):
        obj = np.zeros((12, 14, 3), np.uint8)
        obj[2:10, 3:12] = rng.randint(20, 200, (8, 9, 3))
        folder = os.path.join(base, "amsterdam_object_lib", str(num))
        os.makedirs(folder)
        image_io.imwrite(os.path.join(folder, f"{num}_c.png"), obj)


def _jobs(weights):
    common = {"modelname": "bayesian_fcn", "net_config": NET,
              "starting_weights": weights, "seed": 3}
    return [
        ("misclassification", "main", dict(
            common, dataset=DATA, benchmark="misclassification",
            uncertainty_metrics=["entropy", "variance"])),
        ("out_of_distribution", "main", dict(
            common, dataset=OOD_DATA, benchmark="out_of_distribution",
            uncertainty_metrics=["entropy"])),
        ("measure", "measure", dict(common, dataset=DATA,
                                    uncertainty_metrics=["entropy"])),
        ("search", "uncertainty_parameter_search", dict(
            common, dataset=DATA, benchmark="misclassification",
            search_parameters={"num_samples": [1, 2]},
            uncertainty_metrics=["entropy"])),
        ("train_ambiguous", "train_ambiguous", dict(
            common, dataset=DATA, starting_weights=False,
            method="flip_classes", num_iterations=1,
            uncertainty_metrics=["entropy"], seed=7)),
        ("temperature", "evaluate_temperature_scaling", {
            "temperatures": TEMPERATURES, "seed": 3}),
    ]


def _patch(store, data_basepath):
    patch = pytest.MonkeyPatch()
    for module in (settings, jax_settings):
        patch.setattr(module, "EXPERIMENT_STORAGE_FOLDER", str(store))
        patch.setattr(module, "EXP_OUT", str(store) + "_out")
        patch.setattr(module, "EXPERIMENT_DB_HOST", None)
    patch.setattr(settings, "DATA_BASEPATH", data_basepath)
    return patch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uncertainty")
    data_basepath = str(tmp / "data")
    _write_library(data_basepath)
    description = ({"labels": np.int32, "rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)}, 4)
    jnet = jax_model("bayesian_fcn")(data_description=description, **NET)
    weights = str(tmp / "weights.npz")
    np.savez(weights, **{k: np.asarray(v) for k, v in jnet.variables.items()})
    jobs = _jobs(weights)
    stores = {"port": tmp / "port", "jax": tmp / "jax"}
    process = subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS, json.dumps(jobs)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 EXPERIMENT_STORAGE_FOLDER=str(stores["jax"]),
                 EXP_OUT=str(tmp / "jax_out"), DATA_BASEPATH=data_basepath),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        patch = _patch(stores["port"], data_basepath)
        try:
            for key, command, config in jobs[:-1]:
                uncertainty_eval.ex.run(command, config_updates=dict(
                    copy.deepcopy(config), device="cpu"))
                out["port", key] = uncertainty_eval.ex.current_run.info
        finally:
            patch.undo()
        stdout, stderr = process.communicate(timeout=900)
    finally:
        process.kill()
    assert process.returncode == 0, stderr[-3000:]
    line = next(x for x in stdout.splitlines() if x.startswith("RUNS "))
    jax_runs = json.loads(line[len("RUNS "):])
    for key, (_, info) in jax_runs.items():
        out["jax", key] = port_exp.reverse_convert_datatypes(info)
    # the port's temperature scaling of JAX's ambiguous run
    patch = _patch(stores["jax"], data_basepath)
    try:
        run_id = jax_runs["train_ambiguous"][0]
        uncertainty_eval.ex.run("evaluate_temperature_scaling",
                                config_updates={
                                    "experiments": [run_id], "seed": 3,
                                    "temperatures": TEMPERATURES,
                                    "device": "cpu"})
        out["port", "ambiguous record"] = port_exp.reverse_convert_datatypes(
            port_exp.ExperimentData(run_id).get_record()["info"])
    finally:
        patch.undo()
    return out


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _assert_distribution(got, want):
    _close(got["mean"], want["mean"])
    _close(got["std"], want["std"])
    _close(got["edges"], want["edges"])
    counts, want_counts = np.asarray(got["counts"]), np.asarray(
        want["counts"])
    assert counts.sum() == want_counts.sum()
    # a value within 1e-5 of an edge may fall into the next bin
    assert np.abs(counts - want_counts).sum() <= 2 * max(
        1, int(0.001 * counts.sum()))


def _assert_measurements(got, want):
    _close(got["nll"], want["nll"])
    np.testing.assert_array_equal(got["class_counts"], want["class_counts"])
    _assert_distribution(got["entropy"], want["entropy"])
    _close(got["dirichlet_priors"], want["dirichlet_priors"])
    _close(got["mean_output"], want["mean_output"])


def test_misclassification_benchmark_matches_jax(runs):
    for metric in ("entropy", "variance"):
        got = runs["port", "misclassification"]["measurements"][metric]
        want = runs["jax", "misclassification"]["measurements"][metric]
        assert set(got) == set(want) == {"TPR", "FPR", "AUROC",
                                         "thresholds"}
        assert abs(got["AUROC"] - want["AUROC"]) <= AUROC_ATOL


def test_out_of_distribution_benchmark_matches_jax(runs):
    got = runs["port", "out_of_distribution"]["measurements"]["entropy"]
    want = runs["jax", "out_of_distribution"]["measurements"]["entropy"]
    assert 0.0 <= got["AUROC"] <= 1.0
    assert abs(got["AUROC"] - want["AUROC"]) <= AUROC_ATOL


def test_measure_matches_jax(runs):
    _assert_measurements(runs["port", "measure"]["measurements"],
                         runs["jax", "measure"]["measurements"])


def test_parameter_search_matches_jax(runs):
    got, want = runs["port", "search"]["results"], runs["jax",
                                                          "search"]["results"]
    assert list(got["num_samples"]) == list(want["num_samples"]) == [1, 2]
    np.testing.assert_allclose(got["entropy"]["AUROC"],
                               want["entropy"]["AUROC"], atol=AUROC_ATOL)


def test_train_ambiguous_records_jax_flip(runs):
    got = runs["port", "train_ambiguous"]
    want = runs["jax", "train_ambiguous"]
    flip = got["dataset"]["augmentation"]["label_flip"]
    assert list(flip) == list(want["dataset"]["augmentation"]["label_flip"])
    assert flip[0] != flip[1]
    assert set(got["measurements"]) == set(want["measurements"])
    assert "distribution_miscalibration" in got["measurements"]


def test_temperature_scaling_of_a_jax_run_matches_jax(runs):
    got = runs["port", "ambiguous record"]["temperature_grid_search"]
    want = runs["jax", "ambiguous record"]["temperature_grid_search"]
    assert list(got["temperature_scaling"]) == TEMPERATURES
    assert list(want["temperature_scaling"]) == TEMPERATURES
    _close(got["nll"], want["nll"])
    _close(got["distribution_miscalibration"],
           want["distribution_miscalibration"])
