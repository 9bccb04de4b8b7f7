"""Grid search over network parameters (the port's counterpart of the JAX
package's ``experiments/different_evaluation_parameters.py``).

    python -m modular_semantic_segmentation_torch.experiments.\\
different_evaluation_parameters with modelname=... net_config...=... \\
        'search_parameters={"num_units": [8, 16]}' starting_weights=<id>

Evaluates the model once per combination of the ``search_parameters``
values over ``net_config``, and records the results as lists by key.
"""

from copy import deepcopy

from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import Experiment
from modular_semantic_segmentation_torch.experiments.utils import \
    data_description as describe_data
from modular_semantic_segmentation_torch.experiments.utils import (
    get_observer, load_data)
from modular_semantic_segmentation_torch.experiments.evaluation import (
    evaluate, import_weights_into_network)


def parameter_combinations(search_parameters, net_config):
    """The Cartesian product of the search values, each over a copy of the
    base config."""
    configs_to_test = [net_config]
    for parameter, values in search_parameters.items():
        new_configs = []
        for config in configs_to_test:
            for value in values:
                new_config = deepcopy(config)
                new_config[parameter] = value
                new_configs.append(new_config)
        configs_to_test = new_configs
    return configs_to_test


def _append_deep_value(add_to, value):
    for key, inner in value.items():
        if isinstance(inner, dict):
            _append_deep_value(add_to.setdefault(key, {}), inner)
        else:
            add_to.setdefault(key, []).append(inner)


def grid_search(evaluation, search_parameters, net_config):
    """``evaluation(parameters)`` on every combination; its nested result
    dicts collected into lists, beside the parameters' values."""
    configs_to_test = parameter_combinations(search_parameters, net_config)
    results = {}
    for i, test_parameters in enumerate(configs_to_test):
        print(f"INFO: combination {i + 1} of {len(configs_to_test)}")
        for key in test_parameters:
            results.setdefault(key, []).append(test_parameters[key])
        _append_deep_value(results, evaluation(test_parameters))
    return results


ex = Experiment()
ex.observers.append(get_observer())


@ex.main
def main(starting_weights, modelname, net_config, evaluation_data,
         search_parameters, _run, device="cuda"):
    model = get_model(modelname)
    description = describe_data(evaluation_data)

    def evaluation(parameters):
        with model(data_description=description, device=device,
                   **parameters) as net:
            import_weights_into_network(net, starting_weights)
            measurements, _ = evaluate(net, load_data(evaluation_data))
        return measurements

    _run.info["results"] = grid_search(evaluation, search_parameters,
                                       net_config)


if __name__ == "__main__":
    ex.run_commandline()
