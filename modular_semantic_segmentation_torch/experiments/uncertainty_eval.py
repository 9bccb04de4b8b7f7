"""Uncertainty benchmarks (the port's counterpart of the JAX package's
``experiments/uncertainty_eval.py``): AUROC of an uncertainty metric as a
detector of misclassified or out-of-distribution pixels, NLL and value
distributions, the temperature-scaling grid, training on ambiguous labels.

    python -m modular_semantic_segmentation_torch.experiments.\\
uncertainty_eval [command] with modelname=bayesian_fcn \\
        starting_weights=<run id> dataset.name=add_random_objects \\
        dataset.add_to_dataset=unittest dataset.num_classes=4 \\
        benchmark=out_of_distribution 'uncertainty_metrics=["entropy"]' \\
        net_config.prefix=rgb net_config.modality=rgb [device=cpu]

The models' uncertainty methods are ``models/uncertainty_model.py``'s; the
ROC curves and their areas are the port's own numpy, equal to sklearn's.
"""

from sys import stdout

import numpy as np

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, get_observer)
from modular_semantic_segmentation_torch.experiments.evaluation import \
    import_weights_into_network
from modular_semantic_segmentation_torch.experiments.\
    different_evaluation_parameters import grid_search
from modular_semantic_segmentation_torch.experiments.training import (
    create_directories, train_network)


def evaluate_uncertainty(net, data, metric, benchmark="misclassification",
                         print_results=True):
    """ROC curve and AUROC of the uncertainty ``metric`` (an output of the
    model) as a detector of misclassified pixels or, with
    ``benchmark='out_of_distribution'``, of the pixels labelled 1."""
    if benchmark == "misclassification":
        fpr, tpr, auroc, thresholds = net.misclassification_detection_score(
            data, metric)
    elif benchmark == "out_of_distribution":
        fpr, tpr, auroc, thresholds = \
            net.out_of_distribution_detection_score(data, metric)
    else:
        raise AssertionError(f"unknown benchmark {benchmark}")
    if print_results:
        print('Uncertainty Benchmark "{}" of {} on {} with {} metric'.format(
            benchmark, net.name, type(data).__name__, metric))
        print("AUROC {:.3f}".format(auroc))
        stdout.flush()
    return {"TPR": tpr, "FPR": fpr, "AUROC": auroc,
            "thresholds": thresholds}


def measure_metrics(net, data, metrics, label_flip=None):
    """NLL and class counts, the value distribution of each metric, the
    Dirichlet fitted to the output distributions and their mean; with
    ``label_flip`` (c1, c2, p), how far the mean output over the two
    classes lies from the flipped prior."""
    nll, class_count = net.nll_score(data)
    ret = {"nll": nll, "class_counts": class_count}
    for metric in metrics:
        ret[metric] = net.value_distribution(data, metric)
    if label_flip:
        prior = np.zeros(net.config["num_classes"])
        prior[label_flip[0]] = 1 - label_flip[2]
        prior[label_flip[1]] = label_flip[2]
        ret["distribution_miscalibration"] = net.mean_diff(
            data, prior,
            condition=lambda t, c: np.logical_or(c == label_flip[0],
                                                 c == label_flip[1]))
    dirichlet, mean = net.prob_distribution(data)
    ret["dirichlet_priors"] = dirichlet
    ret["mean_output"] = mean
    return ret


def _description(data_cls, dataset):
    """The dataset class's description with the config's ``num_classes``
    (the class count the model was trained with)."""
    description = list(data_cls.get_data_description())
    if "num_classes" in dataset:
        description[2] = dataset["num_classes"]
    return tuple(description)


def _dataset_params(dataset):
    return {k: v for k, v in dataset.items() if k != "name"}


ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.command
def evaluate_temperature_scaling(experiments, temperatures, _run,
                                 device="cuda"):
    """For each ``train_ambiguous`` run of ``experiments``: its
    measurements at each temperature of ``temperatures``, written into
    that run's record as ``temperature_grid_search``."""
    for exp_id in experiments:
        exp = ExperimentData(exp_id)
        record = exp.get_record()
        dataset = record["info"]["dataset"]
        data_cls = get_dataset(dataset["name"])
        data_description = list(data_cls.get_data_description())
        if record["config"].get("method") == "new_class":
            data_description[2] += 1
        model = get_model(record["config"]["modelname"])
        label_flip = dataset.get("augmentation", {}).get("label_flip")

        def evaluation(parameters):
            with model(data_description=data_description, device=device,
                       **parameters) as net:
                import_weights_into_network(net, exp_id)
                return measure_metrics(
                    net, data_cls(**_dataset_params(dataset)).get_testset(),
                    record["config"]["uncertainty_metrics"],
                    label_flip=label_flip)

        result = grid_search(evaluation,
                             {"temperature_scaling": temperatures},
                             record["config"]["net_config"])
        info = record["info"]
        info["temperature_grid_search"] = result
        exp.update_record({"info": info})


@ex.command
def uncertainty_parameter_search(modelname, net_config, dataset,
                                 starting_weights, search_parameters,
                                 benchmark, uncertainty_metrics, _run,
                                 device="cuda"):
    """The benchmark on the measure set for each combination of
    ``search_parameters`` over ``net_config``."""
    model = get_model(modelname)
    data_cls = get_dataset(dataset["name"])

    def evaluation(parameters):
        with model(data_description=data_cls.get_data_description(),
                   device=device, **parameters) as net:
            measure_set = data_cls(**_dataset_params(dataset)
                                   ).get_measureset()
            import_weights_into_network(net, starting_weights)
            return {metric: evaluate_uncertainty(net, measure_set, metric,
                                                 benchmark=benchmark,
                                                 print_results=False)
                    for metric in uncertainty_metrics}

    _run.info["results"] = grid_search(evaluation, search_parameters,
                                       net_config)


@ex.command
def train_ambiguous(modelname, net_config, dataset, starting_weights,
                    method, num_iterations, uncertainty_metrics, _run,
                    device="cuda"):
    """Train on artificially ambiguous labels, then measure. ``method``:
    'flip_classes' (two random classes, the second taking the first's
    label with a random probability), 'new_class' (optionally [
    'new_class', c]: a new class taking class c's label so) or 'merge'
    (two random classes merged); the draws come from numpy's global
    generator, which the run's seed sets."""
    output_dir = create_directories(_run._id, ex)
    data_cls = get_dataset(dataset["name"])
    data_description = list(data_cls.get_data_description())
    num_classes = data_description[2]

    args = False
    if isinstance(method, list):
        args = method[1:]
        method = method[0]
    if method == "flip_classes":
        classes = np.random.choice(list(range(num_classes)), size=2,
                                   replace=False)
        dataset.setdefault("augmentation", {})["label_flip"] = (
            int(classes[0]), int(classes[1]), float(np.random.rand()))
    elif method == "new_class":
        data_description[2] = num_classes + 1
        old_class = int(args[0]) if args else int(
            np.random.choice(list(range(num_classes))))
        dataset.setdefault("augmentation", {})["label_flip"] = (
            old_class, num_classes, float(np.random.rand()))
    elif method == "merge":
        classes = np.random.choice(list(range(num_classes)), size=2,
                                   replace=False)
        dataset.setdefault("augmentation", {})["label_merge"] = (
            int(classes[0]), int(classes[1]))
    _run.info.setdefault("dataset", {}).update(dataset)

    model = get_model(modelname)
    with model(data_description=tuple(data_description),
               output_dir=output_dir, device=device, **net_config) as net:
        data = data_cls(**_dataset_params(dataset))
        train_network(net, output_dir, data, num_iterations,
                      starting_weights, ex)
        _run.info["measurements"] = measure_metrics(
            net, data.get_testset(), uncertainty_metrics,
            label_flip=dataset["augmentation"].get("label_flip"))


@ex.command
def measure(modelname, net_config, dataset, starting_weights,
            uncertainty_metrics, _run, device="cuda"):
    """``measure_metrics`` of a trained model on the test set."""
    model = get_model(modelname)
    data_cls = get_dataset(dataset["name"])
    with model(data_description=_description(data_cls, dataset),
               device=device, **net_config) as net:
        data = data_cls(**_dataset_params(dataset))
        import_weights_into_network(net, starting_weights)
        _run.info["measurements"] = measure_metrics(
            net, data.get_testset(), uncertainty_metrics)


@ex.main
def uncertainty_benchmark(modelname, net_config, dataset, starting_weights,
                          benchmark, uncertainty_metrics, _run,
                          device="cuda"):
    """The benchmark on the test set, one entry of the run's
    ``measurements`` per metric.

    ``dataset.num_classes`` sets the model's class count, as in
    ``measure``: the out_of_distribution benchmark runs a model trained on
    K classes over a dataset whose labels are the in (0) / out (1) mask
    (``datasets/not_cityscapes.py``), so the model is built with its
    trained K and the scorer reads the labels as a mask."""
    model = get_model(modelname)
    data_cls = get_dataset(dataset["name"])
    with model(data_description=_description(data_cls, dataset),
               device=device, **net_config) as net:
        data = data_cls(**_dataset_params(dataset))
        import_weights_into_network(net, starting_weights)
        for metric in uncertainty_metrics:
            measurements = evaluate_uncertainty(net, data.get_testset(),
                                                metric, benchmark=benchmark)
            _run.info.setdefault("measurements", {})[metric] = measurements


if __name__ == "__main__":
    ex.run_commandline()
