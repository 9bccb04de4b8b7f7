"""Training of a model (the port's counterpart of the JAX package's
``experiments/training.py``).

    python -m modular_semantic_segmentation_torch.experiments.training \\
        with modular_semantic_segmentation_torch/experiments/\\
example_config.json dataset.name=unittest [device=cpu] [key=value ...]

The run trains ``num_iterations`` steps in a fresh directory
``settings.EXP_OUT/<run id>``, validates on the dataset's validation set,
exports the weights, registers every file there (weights, summaries,
event file, checkpoint) as an artifact, and records the test set's
measurements. ``resume with experiment_id=<id>`` continues a run from its
last checkpoint.
"""

import os
import shutil

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, data_description, get_observer)
from modular_semantic_segmentation_torch.experiments.evaluation import (
    evaluate, import_weights_into_network)


def create_directories(run_id, experiment):
    """A clean output directory ``settings.EXP_OUT/<run_id>``, recorded in
    the run's info."""
    root = settings.EXP_OUT
    os.makedirs(root, exist_ok=True)
    output_dir = os.path.join(root, str(run_id))
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)
    os.mkdir(output_dir)
    experiment.info.setdefault("logdirs", []).append(output_dir)
    return output_dir


def train_network(net, output_dir, data, num_iterations, starting_weights,
                  experiment, additional_eval_data=None):
    """Optional warm start, fit (an interrupt ends it and keeps the
    weights), export the weights, register the output directory's files
    as artifacts."""
    if starting_weights:
        import_weights_into_network(net, starting_weights)
    try:
        net.fit(data.get_trainset(), num_iterations,
                validation_dataset=data.get_validation_set(),
                additional_eval_datasets=additional_eval_data or {},
                output=False)
    except KeyboardInterrupt:
        print("WARNING: Got Keyboard Interrupt, will save weights and close")
    net.export_weights()
    for filename in os.listdir(output_dir):
        experiment.add_artifact(os.path.join(output_dir, filename))


ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.capture
def train_and_evaluate(net, output_dir, data, num_iterations,
                       starting_weights, _run):
    train_network(net, output_dir, data, num_iterations, starting_weights,
                  ex)
    measurements, _ = evaluate(net, data)
    _run.info["measurements"] = measurements


def _find_checkpoint(exp_data, run_id):
    """The latest checkpoint of a run: its ``checkpoint.pkl`` artifact (a
    path, or a file object from a zip) if the run registered one, else the
    one in its output directory under ``settings.EXP_OUT``, where a run
    killed mid-fit leaves its periodic checkpoints; None if neither."""
    try:
        return exp_data.get_artifact("checkpoint.pkl")
    except UserWarning:
        candidate = os.path.join(settings.EXP_OUT, str(run_id),
                                 "checkpoint.pkl")
        return candidate if os.path.exists(candidate) else None


@ex.command
def resume(experiment_id, _run, num_iterations=None, device="cuda"):
    """Resume an interrupted training run from its periodic checkpoint.

        python -m modular_semantic_segmentation_torch.experiments.training \\
            resume with experiment_id=12

    Restores the latest ``checkpoint.pkl`` (weights, optimizer state and
    step, written every ``net_config.checkpoint_interval`` steps) of the
    run, or of the newest run of its resume chain that has one, and trains
    the remaining iterations of the original run's target (or of
    ``num_iterations``) in a new run; the original record stays as it
    was. The model and dataset config come from the original training
    run, at the end of the chain.
    """
    run_id = int(experiment_id)
    total = num_iterations
    checkpoint, checkpoint_of = None, None
    seen = set()
    while True:
        if run_id in seen:
            raise UserWarning(f"resume chain loops at run {run_id}")
        seen.add(run_id)
        exp_data = ExperimentData(run_id)
        cfg = exp_data.get_record()["config"]
        if checkpoint is None:
            checkpoint = _find_checkpoint(exp_data, run_id)
            checkpoint_of = run_id
        if total is None and "num_iterations" in cfg:
            total = cfg["num_iterations"]
        if "modelname" in cfg:
            break  # the original training run
        run_id = int(cfg["experiment_id"])  # a resume run: follow it back
    if checkpoint is None:
        raise UserWarning(
            f"no checkpoint.pkl found for run {experiment_id} (set "
            "net_config.checkpoint_interval when training)")
    total = int(total)

    output_dir = create_directories(_run._id, ex)
    data_cls = get_dataset(cfg["dataset"]["name"])
    model = get_model(cfg["modelname"])
    with model(data_description=data_description(cfg["dataset"]),
               output_dir=output_dir, device=device,
               **cfg["net_config"]) as net:
        data = data_cls(**{k: v for k, v in cfg["dataset"].items()
                           if k != "name"})
        net.load_weights(checkpoint)
        remaining = max(total - net.global_step, 0)
        print(f"INFO: resuming run {checkpoint_of} at step "
              f"{net.global_step}; {remaining} iterations remaining")
        train_and_evaluate(net, output_dir, data,
                           num_iterations=remaining,
                           starting_weights=None)


@ex.main
def main(modelname, dataset, net_config, _run, device="cuda"):
    output_dir = create_directories(_run._id, ex)
    data_cls = get_dataset(dataset["name"])
    model = get_model(modelname)
    with model(data_description=data_description(dataset),
               output_dir=output_dir, device=device, **net_config) as net:
        data = data_cls(**{k: v for k, v in dataset.items() if k != "name"})
        train_and_evaluate(net, output_dir, data)


if __name__ == "__main__":
    ex.run_commandline()
