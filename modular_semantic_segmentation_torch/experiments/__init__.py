"""The experiment CLIs of the port (counterparts of the JAX package's
``experiments/``, with their commands): training, evaluation, Bayes and
Dirichlet fusion, the grid search over network parameters, timing (Table
V), the uncertainty benchmarks, finetuning, the progressive FCN, the IBCC
prediction dump, the report of the paper's tables and the rerun of a
stored run.

Each runs as ``python -m modular_semantic_segmentation_torch.experiments.
<name> [command] with <config>.json key=value ...`` and records its run in
the experiment store (``settings.EXPERIMENT_STORAGE_FOLDER``) in the layout
the JAX package's CLIs read and write. A config takes one top-level key
that the JAX package's do not, ``device`` ('cuda' by default; 'cpu' to run
the plain versions of the kernels), which every model the CLI builds gets;
it stays out of ``net_config``, so that either package's CLIs read the
other's records.
"""
