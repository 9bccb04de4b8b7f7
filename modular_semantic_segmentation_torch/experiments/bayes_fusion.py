"""Bayes-fusion fitting and evaluation (the port's counterpart of the JAX
package's ``experiments/bayes_fusion.py``).

    python -m modular_semantic_segmentation_torch.experiments.bayes_fusion \\
        with evaluation_data.dataset=unittest net_config.expert_model=fcn \\
        'net_config.prefixes={"rgb": "rgb", "depth": "depth"}' \\
        'starting_weights={"rgb": <run id>, "depth": <run id>}' [device=cpu]

``fit_and_evaluate`` scores each expert on the measure set (their
confusion matrices, recorded), builds the BayesFusion on them and scores
it on the test set. ``average`` evaluates the Average fusion, and
``collect_data`` dumps per-pixel diagnostics of a past fitting run.
"""

import os
from copy import deepcopy
from sys import stdout

import numpy as np

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    train_test_split
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.average_fusion import \
    AverageFusion
from modular_semantic_segmentation_torch.models.bayes_fusion import \
    BayesFusion
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, data_description, get_observer, load_data)
from modular_semantic_segmentation_torch.experiments.evaluation import \
    import_weights_into_network

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


def split_test_data(data_config):
    """The dataset with augmentation off, and a fixed 50/50 split of its
    test set into (measure items, test items)."""
    params = {key: val for key, val in data_config.items()
              if key not in ["dataset", "name"]}
    params["augmentation"] = {key: False for key in [
        "crop", "scale", "vflip", "hflip", "gamma", "rotate", "shear",
        "contrast", "brightness"]}
    name = data_config.get("dataset", data_config.get("name"))
    data = get_dataset(name)(**params)
    measure_set, test_set = train_test_split(data.testset, test_size=0.5,
                                             random_state=1)
    return data, measure_set, test_set


@ex.command
def collect_data(fitting_experiment, output_path, _run, device="cuda"):
    """Per-pixel predictions, expert probabilities and likelihoods of a
    past fitting run on the test set, as npz files in ``output_path``."""
    record = ExperimentData(fitting_experiment).get_record()
    evaluation_data = record["config"]["evaluation_data"]
    net_config = record["config"]["net_config"]
    starting_weights = record["config"]["starting_weights"]
    confusion_matrices = {
        key: np.array(val) for key, val in
        record["info"]["confusion_matrices"].items()}

    data = load_data(evaluation_data)
    with BayesFusion(data_description=data_description(evaluation_data),
                     confusion_matrices=confusion_matrices, device=device,
                     **net_config) as net:
        import_weights_into_network(net, starting_weights)
        collected = {key: [] for key in
                     ["predictions", "probs", "likelihoods"]}
        test = data.get_testset()
        collected["predictions"].append(net.predict(test))
        for m in net.modalities:
            collected["probs"].append(
                net.predict(test, output_attr=f"{m}_prob"))
            collected["likelihoods"].append(
                net.predict(test, output_attr=f"{m}_likelihood"))
    os.makedirs(output_path, exist_ok=True)
    for key, arrays in collected.items():
        np.savez_compressed(os.path.join(output_path, f"{key}.npz"),
                            *arrays)


@ex.command
def average(net_config, evaluation_data, starting_weights, _run,
            device="cuda"):
    """Evaluate the Average fusion."""
    with AverageFusion(data_description=data_description(evaluation_data),
                       device=device, **net_config) as net:
        data = load_data(evaluation_data)
        import_weights_into_network(net, starting_weights)
        measurements, confusion_matrix = net.score(data.get_testset())
        _run.info["measurements"] = measurements
        _run.info["confusion_matrix"] = confusion_matrix
    print("Evaluated Average Fusion on {} data:".format(
        evaluation_data["dataset"]))
    print("total accuracy {:.3f} IoU {:.3f}".format(
        measurements["total_accuracy"], measurements["mean_IoU"]))
    stdout.flush()


@ex.main
def fit_and_evaluate(net_config, evaluation_data, starting_weights, _run,
                     device="cuda"):
    """Measure the experts, fit the Bayes fusion, evaluate it."""
    expert_model = get_model(net_config["expert_model"])
    confusion_matrices = {}
    for expert in net_config["prefixes"]:
        model_config = deepcopy(net_config)
        model_config.pop("prefixes")
        model_config.pop("expert_model", None)
        model_config["modality"] = expert
        model_config["prefix"] = net_config["prefixes"][expert]
        with expert_model(
                data_description=data_description(evaluation_data),
                device=device, **model_config) as net:
            data = load_data(evaluation_data)
            import_weights_into_network(
                net, starting_weights[model_config["prefix"]])
            _, conf_mat = net.score(data.get_measureset())
            confusion_matrices[expert] = conf_mat
            print("Evaluated network {} on {} measurement set".format(
                expert, evaluation_data["dataset"]))
            m, _ = net.score(data.get_testset())
            print("total accuracy {:.3f} IoU {:.3f}".format(
                m["total_accuracy"], m["mean_IoU"]))
            _run.info.setdefault("measurements", {})[expert] = m
    _run.info["confusion_matrices"] = confusion_matrices

    with BayesFusion(data_description=data_description(evaluation_data),
                     confusion_matrices=confusion_matrices, device=device,
                     **net_config) as net:
        data = load_data(evaluation_data)
        import_weights_into_network(net, starting_weights)
        measurements, confusion_matrix = net.score(data.get_testset())
        _run.info["measurements"]["fusion"] = measurements
        _run.info["confusion_matrix"] = confusion_matrix

    print("Evaluated Bayes Fusion on {} data:".format(
        evaluation_data["dataset"]))
    print("total accuracy {:.3f} IoU {:.3f}".format(
        measurements["total_accuracy"], measurements["mean_IoU"]))
    stdout.flush()


if __name__ == "__main__":
    ex.run_commandline()
