"""Evaluation metrics.

``confusion_matrix`` is accumulated on the device: CUDA tensors go through
the hand-written kernel (``ops/cuda/confusion.py``), CPU tensors through its
plain PyTorch version. The derived measures are the JAX package's
``ops/metrics.measures_from_confusion_matrix``, including the exclusion of
the void class 0 from total_accuracy and mean_IoU.
"""

import numpy as np

# [K, K] float32, rows = true class; labels < 0 (void) are not counted
from modular_semantic_segmentation_torch.ops.cuda.confusion import \
    confusion_matrix  # noqa: F401


def measures_from_confusion_matrix(conf_mat):
    """Recall/precision/F1/mean_F1, total_accuracy and IoU/mean_IoU, the
    last two and total_accuracy EXCLUDING class 0 (void)."""
    conf_mat = np.asarray(conf_mat, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        measures = {"confusion_matrix": conf_mat}
        diag = np.diag(conf_mat)
        measures["recall"] = diag / conf_mat.sum(1)
        measures["precision"] = diag / conf_mat.sum(0)
        measures["F1"] = (2 * measures["precision"] * measures["recall"] /
                          (measures["precision"] + measures["recall"]))
        measures["mean_F1"] = np.nanmean(measures["F1"])
        measures["total_accuracy"] = diag[1:].sum() / conf_mat[1:, :].sum()
        measures["IoU"] = diag / (conf_mat.sum(1) + conf_mat.sum(0) - diag)
        measures["mean_IoU"] = np.nanmean(measures["IoU"][1:])
    return measures
