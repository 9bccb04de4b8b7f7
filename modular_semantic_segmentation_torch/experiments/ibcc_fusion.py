"""Dump the experts' predictions and the ground truth for an external IBCC
analysis (the port's counterpart of the JAX package's
``experiments/ibcc_fusion.py``).

    python -m modular_semantic_segmentation_torch.experiments.ibcc_fusion \\
        with dataset.name=unittest save_to=<directory> \\
        net_config.expert_model=fcn net_config.num_units=64 \\
        'net_config.prefixes={"rgb": "rgb", "depth": "depth"}' \\
        'starting_weights={"rgb": <id>, "depth": <id>}' [device=cpu]

Writes ``<save_to>/predictions.npz``: ``measure_<modality>`` and
``test_<modality>`` (each expert's labels on the measure and test sets)
and ``measure_gt`` / ``test_gt``.
"""

import os
from copy import deepcopy

import numpy as np

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    data_description, get_observer)
from modular_semantic_segmentation_torch.experiments.evaluation import \
    import_weights_into_network

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.main
def collect_data(net_config, dataset, starting_weights, save_to, _run,
                 device="cuda"):
    params = {k: v for k, v in dataset.items() if k != "name"}
    data = get_dataset(dataset["name"])(**params)
    model = get_model(net_config["expert_model"])

    predictions = {}
    for expert in net_config["prefixes"]:
        model_config = deepcopy(net_config)
        model_config.pop("prefixes")
        model_config.pop("expert_model", None)
        model_config["modality"] = expert
        model_config["prefix"] = net_config["prefixes"][expert]
        with model(data_description=data_description(dataset),
                   device=device, **model_config) as net:
            import_weights_into_network(
                net, starting_weights[model_config["prefix"]])
            predictions[f"measure_{expert}"] = net.predict(
                data.get_measureset())
            predictions[f"test_{expert}"] = net.predict(data.get_testset())

    predictions["measure_gt"] = data.get_measureset(
        tf_dataset=False)["labels"]
    predictions["test_gt"] = data.get_testset(tf_dataset=False)["labels"]

    os.makedirs(save_to, exist_ok=True)
    np.savez_compressed(os.path.join(save_to, "predictions.npz"),
                        **predictions)


if __name__ == "__main__":
    ex.run_commandline()
