"""Experiment storage and config access for the CLIs (the port's copy of
the JAX package's ``experiments/utils.py``): a re-export of
``utils/experiment.py``."""

from modular_semantic_segmentation_torch.utils.experiment import (  # noqa
    ExperimentData, data_description, get_observer, load_data,
    reverse_convert_datatypes)
