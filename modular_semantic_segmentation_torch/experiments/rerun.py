"""Rerun a stored run: its recorded command with its recorded config,
through the port's CLI of the same file name (the port's counterpart of
the JAX package's ``experiments/rerun.py``).

    python -m modular_semantic_segmentation_torch.experiments.rerun \\
        with experiment_id=12 [device=cpu]

A record of either package reruns through the port, with the top-level
``device`` of this run (the JAX package's records have none).
"""

import sys

from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, get_observer)
from modular_semantic_segmentation_torch.experiments import (
    bayes_fusion, different_evaluation_parameters, dirichlet_fusion,
    evaluation, finetuning, ibcc_fusion, report, timing,
    train_and_evaluate_progressive, training, uncertainty_eval)

#: a record's ``experiment.mainfile`` -> the port's CLI
module_mapper = {
    "report.py": report,
    "bayes_fusion.py": bayes_fusion,
    "timing.py": timing,
    "training.py": training,
    "evaluation.py": evaluation,
    "different_evaluation_parameters.py": different_evaluation_parameters,
    "dirichlet_fusion.py": dirichlet_fusion,
    "uncertainty_eval.py": uncertainty_eval,
    "finetuning.py": finetuning,
    "train_and_evaluate_progressive.py": train_and_evaluate_progressive,
    "ibcc_fusion.py": ibcc_fusion,
}

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())


@ex.main
def rerun(experiment_id, _run, device="cuda"):
    old_run = ExperimentData(experiment_id).get_record()
    print('Re-Run of experiment "%s"' % old_run["experiment"]["name"])
    module = module_mapper[old_run["experiment"]["mainfile"]]
    command = old_run.get("command", "main")
    config = dict(old_run["config"], device=device)
    return module.ex.run(command, config)


if __name__ == "__main__":
    ex.run_commandline()
    sys.stdout.flush()
