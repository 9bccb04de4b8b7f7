"""Training of the ProgressiveFCN (the port's counterpart of the JAX
package's ``experiments/train_and_evaluate_progressive.py``).

    python -m modular_semantic_segmentation_torch.experiments.\\
train_and_evaluate_progressive rgb_to_depth with \\
        'starting_weights={"experiment_id": <id>}' \\
        data_config.dataset=unittest num_iterations=100 \\
        net_config.prefix=depth net_config.modality=depth \\
        'net_config.lateral_columns={"rgb": "rgb"}' [device=cpu]

``depth_to_rgb`` and ``rgb_to_depth`` start the network from a trained
column of the other modality, its first-layer kernel translated as
``finetuning`` does; ``main`` imports ``starting_weights`` as the
training CLI does.
"""

import tempfile
from os import path

import numpy as np

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models.progressive_fcn import \
    ProgressiveFCN
from modular_semantic_segmentation_torch.utils.sacred_shim import Experiment
from modular_semantic_segmentation_torch.experiments.utils import (
    get_observer, load_data)
from modular_semantic_segmentation_torch.experiments.training import (
    create_directories, train_network)
from modular_semantic_segmentation_torch.experiments.evaluation import (
    evaluate, evaluate_on_all_synthia_seqs)
from modular_semantic_segmentation_torch.experiments.finetuning import (
    _load_experiment_weights, get_all_sequence_validation_sets,
    translate_depth_to_rgb, translate_rgb_to_depth)

ex = Experiment()
ex.observers.append(get_observer())


def _run_progressive(net_config, data_config, num_iterations,
                     starting_weights, translate, _run, device):
    output_dir = create_directories(_run._id, ex)
    data_cls = get_dataset(data_config["dataset"])
    with tempfile.TemporaryDirectory() as tmp:
        imports = starting_weights
        if translate is not None:
            weights = _load_experiment_weights(starting_weights)
            new_weights = translate(weights,
                                    prefix=starting_weights.get("prefix"))
            imports = path.join(tmp, "translated_progressive_weights.npz")
            np.savez(imports, **new_weights)

        with ProgressiveFCN(
                data_description=data_cls.get_data_description(),
                output_dir=output_dir, device=device, **net_config) as net:
            data = load_data(data_config)
            train_network(
                net, output_dir, data, num_iterations,
                starting_weights=imports, experiment=ex,
                additional_eval_data=get_all_sequence_validation_sets(
                    data_config))
            print("INFO: Evaluate the network against the training "
                  "sequences")
            evaluate(net, data)
            if data_config.get("dataset") == "synthia":
                print("INFO: Evaluating against all sequences")
                _run.info["measurements"] = evaluate_on_all_synthia_seqs(
                    net, data_config)


@ex.command
def depth_to_rgb(net_config, data_config, starting_weights, num_iterations,
                 _run, device="cuda"):
    """The trained depth column, its first kernel tiled to rgb."""
    _run_progressive(net_config, data_config, num_iterations,
                     dict(starting_weights, prefix="depth"),
                     translate_depth_to_rgb, _run, device)


@ex.command
def rgb_to_depth(net_config, data_config, starting_weights, num_iterations,
                 _run, device="cuda"):
    """The trained rgb column, its first kernel averaged to depth."""
    _run_progressive(net_config, data_config, num_iterations,
                     dict(starting_weights, prefix="rgb"),
                     translate_rgb_to_depth, _run, device)


@ex.main
def main(net_config, data_config, starting_weights, num_iterations, _run,
         device="cuda"):
    _run_progressive(net_config, data_config, num_iterations,
                     starting_weights, None, _run, device)


if __name__ == "__main__":
    ex.run_commandline()
