"""Dirichlet-fusion fitting and evaluation (the port's counterpart of the
JAX package's ``experiments/dirichlet_fusion.py``).

    python -m modular_semantic_segmentation_torch.experiments.\\
dirichlet_fusion with evaluation_data.dataset=unittest \\
        net_config.expert_model=fcn net_config.use_pallas=true \\
        'net_config.prefixes={"rgb": "rgb", "depth": "depth"}' \\
        'starting_weights={"rgb": <run id>, "depth": <run id>}' [device=cpu]

``fit_and_evaluate`` fits the Dirichlet parameters by EM on one half of
the test set and scores the other half; the parameters are recorded as
the ``counts.npz`` artifact, which ``DirichletFusion(measurement_exp=<run
id>)`` loads. ``test_parameters`` searches sigma, delta and beta over one
sufficient statistic.
"""

import os
import tempfile
from sys import stdout

import numpy as np

from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataSource, train_test_split)
from modular_semantic_segmentation_torch.models.dirichlet_fusion import \
    DirichletFusion
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import \
    data_description as describe_data
from modular_semantic_segmentation_torch.experiments.utils import \
    get_observer
from modular_semantic_segmentation_torch.experiments.evaluation import \
    import_weights_into_network
from modular_semantic_segmentation_torch.experiments.\
    different_evaluation_parameters import parameter_combinations
from modular_semantic_segmentation_torch.experiments.bayes_fusion import \
    split_test_data

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.command
def test_parameters(net_config, evaluation_data, starting_weights,
                    search_parameters, _run, device="cuda"):
    """Grid search over the fit's parameters (sigma, delta, beta ...),
    all fitted on one sufficient statistic of half the measure items and
    scored on the other half."""
    configs_to_test = parameter_combinations(search_parameters, net_config)
    data, _, _ = split_test_data(evaluation_data)
    description = describe_data(evaluation_data)
    search_data, search_validation = train_test_split(
        data.measureset, test_size=0.5, random_state=1)

    with DirichletFusion(data_description=description, device=device,
                         **configs_to_test[0]) as net:
        import_weights_into_network(net, starting_weights)
        sufficient_statistic = net._get_sufficient_statistic(
            DataSource(data, search_data))

    results = []
    for test_config in configs_to_test:
        with DirichletFusion(data_description=description, device=device,
                             **test_config) as net:
            import_weights_into_network(net, starting_weights)
            net._fit_sufficient_statistic(*sufficient_statistic)
            measurements, _ = net.score(DataSource(data, search_validation))
            result = dict(test_config)
            result.update(measurements)
            results.append(result)
    _run.info["results"] = dict(
        zip(results[0], zip(*[r.values() for r in results])))


@ex.main
def fit_and_evaluate(net_config, evaluation_data, starting_weights, _run,
                     device="cuda"):
    """Import the experts' weights, fit by EM on the measure half, score
    the test half, record the parameters as ``counts.npz``."""
    data, measure_set, test_set = split_test_data(evaluation_data)
    description = describe_data(evaluation_data)

    with DirichletFusion(data_description=description, device=device,
                         **net_config) as net:
        import_weights_into_network(net, starting_weights)
        dirichlet_params = net.fit(DataSource(data, measure_set))
        measurements, confusion_matrix = net.score(
            DataSource(data, test_set))
        _run.info["measurements"] = measurements
        _run.info["confusion_matrix"] = confusion_matrix
        _run.info["dirichlet_params"] = dirichlet_params
        with tempfile.TemporaryDirectory() as tmp:
            counts_file = os.path.join(tmp, "counts.npz")
            np.savez(counts_file, **{k: np.asarray(v)
                                     for k, v in dirichlet_params.items()})
            ex.add_artifact(counts_file, "counts.npz")

    print("Evaluated Dirichlet Fusion on {} data:".format(
        evaluation_data["dataset"]))
    print("total accuracy {:.3f} IoU {:.3f}".format(
        measurements["total_accuracy"], measurements["mean_IoU"]))
    stdout.flush()


if __name__ == "__main__":
    ex.run_commandline()
