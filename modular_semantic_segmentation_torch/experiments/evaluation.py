"""Evaluation of trained models (the port's counterpart of the JAX
package's ``experiments/evaluation.py``).

    python -m modular_semantic_segmentation_torch.experiments.evaluation \\
        with modelname=simple_fcn starting_weights=<run id> \\
        evaluation_data.dataset=unittest net_config.prefix=rgb \\
        net_config.modality=rgb net_config.num_units=64 [device=cpu]

The run's info holds the measurements and the test set's confusion matrix
(``BayesFusion(eval_experiments=...)`` loads it); ``quantized_serving``
scores through int8 serving and records the scales. ``all_synthia``
scores the network on each SYNTHIA sequence in turn.
"""

import os
from copy import deepcopy
from sys import stdout

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, data_description, get_observer, load_data)


def evaluate(net, data, print_results=True):
    """Score the network on the dataset's test set and print the per-class
    results. Returns (measures, confusion matrix)."""
    measures, confusion_matrix = net.score(data.get_testset())
    if print_results:
        print("Evaluated network on %s:" % type(data).__name__)
        print("total accuracy {:.3f} mean F1 {:.3f} IoU {:.3f}".format(
            measures["total_accuracy"], measures["mean_F1"],
            measures["mean_IoU"]))
        for label in sorted(data.labelinfo):
            if label >= len(measures["precision"]):
                continue
            print("{:>15}: {:.2f} precision, {:.2f} recall, {:.2f} IoU"
                  .format(data.labelinfo[label]["name"],
                          measures["precision"][label],
                          measures["recall"][label],
                          measures["IoU"][label]))
        stdout.flush()
    return measures, confusion_matrix


def evaluate_on_all_synthia_seqs(net, data_config):
    """Score the network on each SYNTHIA sequence of
    ``AVAILABLE_SEQUENCES`` in turn (the dataset config with ``seqs`` set
    to that sequence alone); returns {sequence: measures}."""
    from modular_semantic_segmentation_torch.datasets.synthia import \
        AVAILABLE_SEQUENCES
    adapted_config = deepcopy(data_config)
    all_measurements = {}
    for sequence in AVAILABLE_SEQUENCES:
        adapted_config["seqs"] = [sequence]
        data = load_data(adapted_config)
        measurements, _ = evaluate(net, data, print_results=False)
        print("Evaluated network on {}: {:.2f} IoU".format(
            sequence, measurements["mean_IoU"]))
        all_measurements[sequence] = measurements
    stdout.flush()
    return all_measurements


def import_weights_into_network(net, starting_weights, **kwargs):
    """Import weights by descriptor:
        * 'paul_adapnet' / 'imagenet_adapnet': npz files in
          ``settings.DATA_BASEPATH``;
        * a path of an existing file: imported directly;
        * an experiment id: that run's weights artifact;
        * a dict {prefix: descriptor}: one import per expert, the prefix
          translated; a list: imported in turn.
    """
    def import_one(description, prefix=False):
        if description == "paul_adapnet":
            net.import_weights(
                os.path.join(settings.DATA_BASEPATH,
                             "Adapnet_weights_160000.npz"),
                chill_mode=True, translate_prefix=prefix, **kwargs)
            return
        if description == "imagenet_adapnet":
            net.import_weights(
                os.path.join(settings.DATA_BASEPATH,
                             "resnet50_imagenet.npz"),
                chill_mode=True, translate_prefix=prefix, **kwargs)
            return
        if isinstance(description, str) and os.path.exists(description):
            net.import_weights(description, translate_prefix=prefix,
                               **kwargs)
            return
        net.import_weights(ExperimentData(description).get_weights(),
                           translate_prefix=prefix, **kwargs)

    if isinstance(starting_weights, list):
        for description in starting_weights:
            import_one(description)
    elif isinstance(starting_weights, dict):
        for prefix, description in starting_weights.items():
            import_one(description, prefix=prefix)
    else:
        import_one(starting_weights)


ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.command
def also_load_config(modelname, net_config, evaluation_data,
                     starting_weights, _run, device="cuda"):
    """Evaluate with the net config of the training run, updated by
    ``net_config``."""
    training_experiment = ExperimentData(starting_weights)
    model_config = training_experiment.get_record()["config"]["net_config"]
    model_config.update(net_config)
    print("Running with net_config:")
    print(model_config)
    model = get_model(modelname)
    with model(data_description=data_description(evaluation_data),
               device=device, **model_config) as net:
        import_weights_into_network(net, starting_weights)
        data = load_data(evaluation_data)
        measurements, confusion_matrix = evaluate(net, data)
        _run.info["measurements"] = measurements
        _run.info["confusion_matrix"] = confusion_matrix


@ex.command
def all_synthia(modelname, net_config, evaluation_data, starting_weights,
                _run, device="cuda"):
    """Evaluation on every SYNTHIA sequence, one at a time; the run's info
    holds {sequence: measurements}."""
    model = get_model(modelname)
    with model(data_description=data_description(evaluation_data),
               device=device, **net_config) as net:
        import_weights_into_network(net, starting_weights)
        measurements = evaluate_on_all_synthia_seqs(net, evaluation_data)
        _run.info["measurements"] = measurements


@ex.main
def main(modelname, net_config, evaluation_data, starting_weights, _run,
         quantized_serving=False, device="cuda"):
    """Evaluate; ``quantized_serving=True`` calibrates int8 scales on the
    measure set first and scores the test set through int8 serving (an
    integer instead of True sets the least input channels of an int8
    conv, 128 by default)."""
    model = get_model(modelname)
    with model(data_description=data_description(evaluation_data),
               device=device, **net_config) as net:
        import_weights_into_network(net, starting_weights)
        data = load_data(evaluation_data)
        if quantized_serving:
            min_ch = (int(quantized_serving)
                      if not isinstance(quantized_serving, bool) else 128)
            scales = net.quantize_for_serving(data.get_measureset(),
                                              min_channels=min_ch)
            _run.info["quantization_scales"] = scales
        measurements, confusion_matrix = evaluate(net, data)
        _run.info["measurements"] = measurements
        _run.info["confusion_matrix"] = confusion_matrix


if __name__ == "__main__":
    ex.run_commandline()
