"""Cross-modal transfer and finetuning of the SimpleFCN expert (the port's
counterpart of the JAX package's ``experiments/finetuning.py``).

    python -m modular_semantic_segmentation_torch.experiments.finetuning \\
        rgb_to_depth with 'starting_weights={"experiment_id": <id>}' \\
        data_config.dataset=unittest num_iterations=100 \\
        net_config.prefix=rgb net_config.modality=depth [device=cpu]

The first-layer kernel surgery: depth -> rgb tiles the one-channel kernel
to three channels, rgb -> depth averages the three channels into one. On
SYNTHIA, each sequence's validation set is scored during training and each
sequence evaluated at the end.
"""

import tempfile
from copy import deepcopy
from os import path

import numpy as np

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models.simple_fcn import SimpleFCN
from modular_semantic_segmentation_torch.utils.sacred_shim import Experiment
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, get_observer, load_data)
from modular_semantic_segmentation_torch.experiments.training import (
    create_directories, train_network)
from modular_semantic_segmentation_torch.experiments.evaluation import (
    evaluate, evaluate_on_all_synthia_seqs)

ex = Experiment()
ex.observers.append(get_observer())


def get_all_sequence_validation_sets(data_config):
    """{sequence: its first 15 validation frames} for every SYNTHIA
    sequence when the dataset is SYNTHIA; {} otherwise."""
    all_sequences = {}
    if data_config.get("dataset") == "synthia":
        from modular_semantic_segmentation_torch.datasets.synthia import \
            AVAILABLE_SEQUENCES
        adapted_config = deepcopy(data_config)
        for sequence in AVAILABLE_SEQUENCES:
            adapted_config["seqs"] = [sequence]
            data = load_data(adapted_config)
            all_sequences[sequence] = data.get_validation_set(num_items=15)
    return all_sequences


def _load_experiment_weights(starting_weights):
    """The weights artifact of the run ``starting_weights['experiment_id']``
    as a {name: array} dict."""
    training_experiment = ExperimentData(starting_weights["experiment_id"])
    filename = next(
        artifact["name"]
        for artifact in training_experiment.get_record()["artifacts"]
        if "weights" in artifact["name"])
    weights_file = training_experiment.get_artifact(filename)
    return dict(np.load(weights_file))


def _first_kernel(weights, prefix):
    """The name of the first conv's kernel, in either spelling."""
    key = f"{prefix}_conv1_1/kernel"
    return key if key in weights else f"{prefix}/conv1_1/kernel"


def translate_depth_to_rgb(weights, prefix="depth"):
    """Tile the one-channel first-layer kernel to three channels."""
    new_weights = dict(weights)
    key = _first_kernel(weights, prefix)
    new_weights[key] = np.tile(weights[key], [1, 1, 3, 1])
    return new_weights


def translate_rgb_to_depth(weights, prefix="rgb"):
    """Average the three-channel first-layer kernel into one channel."""
    new_weights = dict(weights)
    key = _first_kernel(weights, prefix)
    new_weights[key] = weights[key].mean(2, keepdims=True)
    return new_weights


def _finetune(net_config, data_config, num_iterations, starting_weights,
              translate, _run, device):
    output_dir = create_directories(_run._id, ex)
    weights = _load_experiment_weights(starting_weights)
    default_prefix = ("depth" if translate is translate_depth_to_rgb
                      else "rgb")
    new_weights = translate(weights, prefix=starting_weights.get(
        "prefix", default_prefix))
    data_cls = get_dataset(data_config["dataset"])
    with tempfile.TemporaryDirectory() as tmp, SimpleFCN(
            data_description=data_cls.get_data_description(),
            output_dir=output_dir, device=device, **net_config) as net:
        translated = path.join(tmp, "translated_weights.npz")
        np.savez(translated, **new_weights)
        net.import_weights(translated, warnings=False)
        data = load_data(data_config)
        train_network(net, output_dir, data, num_iterations,
                      starting_weights=False, experiment=ex,
                      additional_eval_data=get_all_sequence_validation_sets(
                          data_config))
        print("INFO: Evaluate the network against the training sequences")
        evaluate(net, data)
        if data_config.get("dataset") == "synthia":
            print("INFO: Evaluating against all sequences")
            _run.info["measurements"] = evaluate_on_all_synthia_seqs(
                net, data_config)


@ex.command
def depth_to_rgb(net_config, data_config, num_iterations, starting_weights,
                 _run, device="cuda"):
    _finetune(net_config, data_config, num_iterations, starting_weights,
              translate_depth_to_rgb, _run, device)


@ex.command
def rgb_to_depth(net_config, data_config, num_iterations, starting_weights,
                 _run, device="cuda"):
    _finetune(net_config, data_config, num_iterations, starting_weights,
              translate_rgb_to_depth, _run, device)


@ex.main
def train(net_config, data_config, num_iterations, starting_weights, _run,
          device="cuda"):
    """Train a SimpleFCN (from ``starting_weights``, as the training CLI
    imports them), with the SYNTHIA sequences' validation and
    evaluation."""
    output_dir = create_directories(_run._id, ex)
    data_cls = get_dataset(data_config["dataset"])
    with SimpleFCN(data_description=data_cls.get_data_description(),
                   output_dir=output_dir, device=device, **net_config) as net:
        data = load_data(data_config)
        train_network(net, output_dir, data, num_iterations,
                      starting_weights=starting_weights, experiment=ex,
                      additional_eval_data=get_all_sequence_validation_sets(
                          data_config))
        evaluate(net, data)
        if data_config.get("dataset") == "synthia":
            _run.info["measurements"] = evaluate_on_all_synthia_seqs(
                net, data_config)


if __name__ == "__main__":
    ex.run_commandline()
