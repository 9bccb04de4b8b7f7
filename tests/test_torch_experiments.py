"""The port's experiment CLIs against the JAX package's, on the CPU.

One experiment store for the module. The port trains an rgb expert
(in-process, ``device=cpu``); one subprocess then runs the JAX package's
CLIs in turn, as ``python -m experiments.<name>`` would: ``training`` of
an rgb and a depth expert, ``evaluation also_load_config`` of the port's
run, and ``bayes_fusion`` and ``dirichlet_fusion`` on its own two
experts; then the port runs its ``evaluation``, ``bayes_fusion`` and
``dirichlet_fusion`` on JAX's experts. Small: 32x32 UnittestData,
``num_units`` 4, ``channel_factor`` 0.25.

Held: confusion matrices of the two packages on the same weights are
equal, or differ by at most two counts per pixel whose two best expert
probabilities lie within 1e-5 (the SimpleFCN tests' near ties); the
Dirichlet parameters through the EM's input, within rtol 1e-3
(tests/test_torch_dirichlet_fit.py; see that test for why); each package
reads the other's runs and both write into one store without clashing
ids.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import modular_semantic_segmentation_tpu.settings as jax_settings
from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.utils import experiment as jax_exp
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.experiments import (
    bayes_fusion, different_evaluation_parameters, dirichlet_fusion,
    evaluation, training)
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.dirichlet_fusion import \
    load_measurements
from modular_semantic_segmentation_torch.utils import experiment as port_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = {"height": 32, "width": 32, "num_train": 6, "num_measure": 2,
        "num_test": 4}
EVAL_DATA = {"dataset": "unittest", **DATA}
NET = {"num_units": 4, "channel_factor": 0.25, "batchsize": 2,
       "learning_rate": 0.01}
FUSION = {"num_units": 4, "channel_factor": 0.25, "batchsize": 2,
          "expert_model": "fcn", "prefixes": {"rgb": "rgb", "depth": "depth"}}
TIE = 1e-5

# the JAX package's CLIs, one after the other in one process; prints the
# run ids as one JSON line
JAX_CLIS = """
import json, sys
from experiments import bayes_fusion, dirichlet_fusion, evaluation, training
args = json.loads(sys.argv[1])
ids = {}
for key, module, argv in args:
    module = {"training": training, "evaluation": evaluation,
              "bayes_fusion": bayes_fusion,
              "dirichlet_fusion": dirichlet_fusion}[module]
    module.ex.run_commandline(argv)
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


def _with(config, prefix=""):
    """``key=value`` arguments of a (nested) config, dicts as JSON."""
    out = []
    for key, value in config.items():
        if isinstance(value, dict) and key != "prefixes":
            out += _with(value, f"{prefix}{key}.")
        else:
            out.append(f"{prefix}{key}={json.dumps(value)}")
    return out


def _run_jax(jobs, store):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               EXPERIMENT_STORAGE_FOLDER=str(store / "experiments"),
               EXP_OUT=str(store / "exp"), DATA_BASEPATH=str(store / "data"))
    result = subprocess.run(
        [sys.executable, "-c", JAX_CLIS, json.dumps(jobs)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    line = next(x for x in result.stdout.splitlines()
                if x.startswith("RUN_IDS "))
    return json.loads(line[len("RUN_IDS "):])


def _port_run(module, config, command="main"):
    module.ex.run(command, config_updates=dict(config, device="cpu"))
    return module.ex.current_run._id


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: run id} of every run of the module, all in one store."""
    store = tmp_path_factory.mktemp("store")
    with pytest.MonkeyPatch.context() as patch:
        for module in (settings, jax_settings):
            patch.setattr(module, "EXPERIMENT_STORAGE_FOLDER",
                          str(store / "experiments"))
            patch.setattr(module, "EXP_OUT", str(store / "exp"))
            patch.setattr(module, "EXPERIMENT_DB_HOST", None)
        ids = {"port training rgb": _port_run(training, {
            "modelname": "simple_fcn", "num_iterations": 2, "seed": 1,
            "starting_weights": False,
            "dataset": {"name": "unittest", **DATA},
            "net_config": dict(NET, prefix="rgb", modality="rgb",
                               checkpoint_interval=1)})}
        training_args = [
            "modelname=simple_fcn", "num_iterations=2", "seed=1",
            "starting_weights=false"] + _with(
            {"dataset": {"name": "unittest", **DATA}})
        experts = {m: f"jax training {m}" for m in ("rgb", "depth")}
        jobs = [(experts[m], "training", ["with"] + training_args + _with(
            {"net_config": dict(NET, prefix=m, modality=m)}))
            for m in ("rgb", "depth")]
        jobs.append(("jax evaluation of the port's run", "evaluation", [
            "also_load_config", "with", "modelname=simple_fcn", "seed=1",
            f"starting_weights={ids['port training rgb']}"] + _with(
            {"evaluation_data": EVAL_DATA, "net_config": {"batchsize": 2}})))
        fusion_jobs = {"bayes_fusion": FUSION,
                       "dirichlet_fusion": dict(FUSION, sigma=0.1)}
        n = len(os.listdir(store / "experiments"))
        weights = {m: n + 1 + i for i, m in enumerate(("rgb", "depth"))}
        for name, net_config in fusion_jobs.items():
            jobs.append((f"jax {name}", name, ["with", "seed=1",
                         f"starting_weights={json.dumps(weights)}"]
                         + _with({"evaluation_data": EVAL_DATA,
                                  "net_config": net_config})))
        ids.update(_run_jax(jobs, store))
        assert {m: ids[experts[m]] for m in weights} == weights
        ids["port evaluation of jax rgb"] = _port_run(evaluation, {
            "modelname": "simple_fcn", "seed": 1,
            "starting_weights": weights["rgb"],
            "evaluation_data": EVAL_DATA,
            "net_config": dict(NET, prefix="rgb", modality="rgb")})
        for name, net_config in fusion_jobs.items():
            ids[f"port {name}"] = _port_run(
                {"bayes_fusion": bayes_fusion,
                 "dirichlet_fusion": dirichlet_fusion}[name], {
                    "seed": 1, "starting_weights": weights,
                    "evaluation_data": EVAL_DATA, "net_config": net_config})
        ids["port resume"] = _port_run(training, {
            "experiment_id": ids["port training rgb"], "num_iterations": 4},
            command="resume")
        yield ids


def _info(run_id):
    return port_exp.ExperimentData(run_id).get_record()["info"]


def _near_ties(net, data):
    """Pixels of ``data``'s test set whose two best probabilities of
    ``net`` lie within TIE."""
    prob = np.sort(net.predict(data.get_testset(), output_attr="prob"), -1)
    return int((prob[..., -1] - prob[..., -2] <= TIE).sum())


def _expert(prefix, weights_run):
    data = get_dataset("unittest")(**DATA)
    net = get_model("simple_fcn")(
        data_description=data.get_data_description(), prefix=prefix,
        modality=prefix, device="cpu", **NET)
    evaluation.import_weights_into_network(net, weights_run)
    return net, data


def _assert_counts_close(got, want, net, data):
    """Equal confusion matrices, or differences only at near ties."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() <= 2 * _near_ties(net, data)


def test_port_training_records_the_jax_layout(runs):
    run_dir = os.path.join(settings.EXPERIMENT_STORAGE_FOLDER,
                           str(runs["port training rgb"]))
    files = set(os.listdir(run_dir))
    assert {"run.json", "config.json", "info.json", "cout.txt",
            "summaries.jsonl", "checkpoint.pkl",
            "SimpleFCN_weights_2.npz"} <= files
    assert any(f.startswith("events.out.tfevents") for f in files)
    record = jax_exp.ExperimentData(runs["port training rgb"]).get_record()
    assert record["status"] == "COMPLETED"
    assert record["config"]["device"] == "cpu"
    assert "device" not in record["config"]["net_config"]
    assert "measurements" in record["info"]
    assert sorted(a["name"] for a in record["artifacts"]) == sorted(
        files - {"run.json", "config.json", "info.json", "cout.txt"})


def test_port_evaluation_of_a_jax_run_gives_jax_counts(runs):
    """The port's evaluation of JAX's rgb run against the test set's
    confusion matrix that JAX's training run recorded."""
    got = _info(runs["port evaluation of jax rgb"])["confusion_matrix"]
    want = _info(runs["jax training rgb"])["measurements"][
        "confusion_matrix"]
    _assert_counts_close(got, want, *_expert("rgb",
                                             runs["jax training rgb"]))


def test_jax_evaluation_reads_a_port_run(runs):
    """JAX's ``also_load_config`` takes the port's run's weights and net
    config, and counts what the port's training run recorded."""
    record = jax_exp.ExperimentData(
        runs["jax evaluation of the port's run"]).get_record()
    assert record["status"] == "COMPLETED"
    assert "'channel_factor': 0.25" in record["captured_out"]
    want = _info(runs["port training rgb"])["measurements"][
        "confusion_matrix"]
    _assert_counts_close(record["info"]["confusion_matrix"], want,
                         *_expert("rgb", runs["port training rgb"]))


def test_port_bayes_fusion_matches_jax(runs):
    got, want = _info(runs["port bayes_fusion"]), _info(runs["jax "
                                                             "bayes_fusion"])
    for m in ("rgb", "depth"):
        net, data = _expert(m, runs[f"jax training {m}"])
        _assert_counts_close(got["confusion_matrices"][m],
                             want["confusion_matrices"][m], net, data)
    assert set(got["measurements"]) == {"rgb", "depth", "fusion"}
    assert np.asarray(got["confusion_matrix"]).sum() == np.asarray(
        want["confusion_matrix"]).sum()
    if all(np.array_equal(got["confusion_matrices"][m],
                          want["confusion_matrices"][m])
           for m in ("rgb", "depth")):
        np.testing.assert_array_equal(got["confusion_matrix"],
                                      want["confusion_matrix"])


def test_port_dirichlet_fusion_matches_jax(runs):
    """The fitted parameters of the two CLIs (each run's ``counts.npz``).

    Each package fits by EM on its own float32 sufficient statistic of
    the measure half, and the two statistics part by float32 summation
    order (rtol 1e-4 of the largest). The EM of an expert trained for 2
    steps is ill-conditioned for some classes: the port's EM on the
    port's statistic and on JAX's part by up to a third there (rgb, class
    1, at this seed). So the parameters are held through the EM's input:
    the port's run holds the port's EM of the port's statistic (rtol
    1e-6), and the port's EM of JAX's statistic gives JAX's run's
    parameters within rtol 1e-3 (tests/test_torch_dirichlet_fit.py).
    The class counts are exact, and each package's DirichletFusion loads
    the other's run through ``measurement_exp``."""
    from modular_semantic_segmentation_tpu.datasets import \
        data_baseclass as jax_base
    from modular_semantic_segmentation_tpu.datasets import \
        get_dataset as jax_dataset
    from modular_semantic_segmentation_torch.datasets.data_baseclass import \
        DataSource
    import experiments.evaluation as jax_evaluation
    port_id, jax_id = runs["port dirichlet_fusion"], runs[
        "jax dirichlet_fusion"]
    ours, theirs = load_measurements(port_id), load_measurements(jax_id)
    assert sorted(ours) == sorted(theirs) == ["class_counts", "depth", "rgb"]
    np.testing.assert_array_equal(ours["class_counts"],
                                  theirs["class_counts"])
    data, measure_items, _ = bayes_fusion.split_test_data(EVAL_DATA)
    description = data.get_data_description()
    weights = {m: runs[f"jax training {m}"] for m in ("rgb", "depth")}
    config = dict(FUSION, sigma=0.1)
    net = get_model("dirichlet_mix")(data_description=description,
                                     device="cpu", **config)
    evaluation.import_weights_into_network(net, weights, warnings=False)
    jnet = jax_model("dirichlet_mix")(data_description=description,
                                      **config)
    jax_evaluation.import_weights_into_network(jnet, weights, warnings=False)
    jax_data = jax_dataset("unittest")(**DATA)
    stats = {"port": net._get_sufficient_statistic(
        DataSource(data, measure_items)),
        "jax": jnet._get_sufficient_statistic(
        jax_base.DataSource(jax_data, measure_items))}
    stats["jax"] = ({m: np.asarray(v, np.float64)
                     for m, v in stats["jax"][0].items()},
                    np.asarray(stats["jax"][1]))
    for m in ("rgb", "depth"):
        got, want = stats["port"][0][m], stats["jax"][0][m]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for source, run_params, rtol in (("port", ours, 1e-6),
                                     ("jax", theirs, 1e-3)):
        net._fit_sufficient_statistic(*stats[source])
        for m in ("rgb", "depth"):
            np.testing.assert_allclose(net.dirichlet_params[m],
                                       run_params[m], rtol=rtol,
                                       err_msg=f"{source} {m}")
    loaded = get_model("dirichlet_mix")(data_description=description,
                                        measurement_exp=jax_id, device="cpu",
                                        **FUSION)
    jax_loaded = jax_model("dirichlet_mix")(data_description=description,
                                            measurement_exp=port_id,
                                            **FUSION)
    for m in ("rgb", "depth"):
        np.testing.assert_array_equal(loaded.dirichlet_params[m], theirs[m])
        np.testing.assert_array_equal(jax_loaded.dirichlet_params[m],
                                      ours[m])
    assert _info(port_id)["measurements"]["mean_IoU"] >= 0


def test_training_resume_from_a_port_checkpoint(runs):
    """``training resume`` continues the port's run from its checkpoint
    (step 2 of 4) in a new run."""
    record = port_exp.ExperimentData(runs["port resume"]).get_record()
    assert record["status"] == "COMPLETED"
    assert (f"resuming run {runs['port training rgb']} at step 2; 2 "
            "iterations remaining") in record["captured_out"]
    assert any(a["name"] == "SimpleFCN_weights_4.npz"
               for a in record["artifacts"])
    assert record["config"]["experiment_id"] == runs["port training rgb"]


def test_both_packages_share_one_store(runs):
    """Distinct ids for every run of either package, each run read alike
    by both packages' ExperimentData."""
    ids = sorted(runs.values())
    assert ids == list(range(1, len(ids) + 1))
    for run_id in ids:
        ours = port_exp.ExperimentData(run_id).get_record()
        theirs = jax_exp.ExperimentData(run_id).get_record()
        assert ours["status"] == theirs["status"] == "COMPLETED"
        assert json.dumps(ours["config"], sort_keys=True) == json.dumps(
            theirs["config"], sort_keys=True)


def test_grid_search_collects_lists():
    combos = different_evaluation_parameters.parameter_combinations(
        {"a": [1, 2], "b": [3, 4]}, {"c": 5})
    assert len(combos) == 4
    results = different_evaluation_parameters.grid_search(
        lambda p: {"sum": p["a"] + p["b"], "deep": {"x": p["a"]}},
        {"a": [1, 2]}, {"b": 10})
    assert results["sum"] == [11, 12]
    assert results["a"] == [1, 2]
    assert results["deep"] == {"x": [1, 2]}


def test_cli_refuses_cuda_without_a_card(runs):
    """The default device is the card: without one a CLI raises, as the
    models do, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        evaluation.ex.run(config_updates={
            "modelname": "simple_fcn", "starting_weights":
                runs["port training rgb"], "evaluation_data": EVAL_DATA,
            "net_config": dict(NET, prefix="rgb", modality="rgb")})


def test_all_synthia_waits_for_its_dataset(runs, tmp_path):
    """Without a SYNTHIA tree ``all_synthia`` raises the driver's IOError,
    as JAX's does (tests/test_torch_dataset_drivers.py runs it on one)."""
    with pytest.raises(IOError, match="SYNTHIA"):
        evaluation.ex.run("all_synthia", config_updates={
            "modelname": "simple_fcn", "device": "cpu",
            "starting_weights": runs["port training rgb"],
            "evaluation_data": {"dataset": "synthia",
                                "base_path": str(tmp_path / "missing")},
            "net_config": dict(NET, prefix="rgb", modality="rgb")})


def test_context_manager_and_output_attr_fallback():
    """``with Model(...) as net`` closes the model; ``predict`` falls back
    to a model attribute for a name that is no test output, batch by
    batch, as JAX's does."""
    data = get_dataset("unittest")(num_test=3, **{
        k: v for k, v in DATA.items() if k != "num_test"})
    description = data.get_data_description()
    params = {"rgb": np.full((4, 4), 2.0), "depth": np.full((4, 4), 3.0),
              "class_counts": np.array([1.0, 5.0, 3.0, 2.0])}
    frames = data.get_testset(tf_dataset=False)
    out = []
    for factory in (get_model, jax_model):
        config = dict(data_description=description, dirichlet_params=params,
                      **dict(FUSION, batchsize=2))
        if factory is get_model:
            config["device"] = "cpu"
        with factory("dirichlet_mix")(**config) as net:
            out.append(net.predict(frames, output_attr="class_counts"))
            with pytest.raises(AttributeError, match="unknown output_attr"):
                net.predict(frames, output_attr="no_such_output")
        assert net._closed
    np.testing.assert_array_equal(out[0], out[1])
