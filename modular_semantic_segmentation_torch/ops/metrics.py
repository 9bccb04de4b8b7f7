"""Evaluation metrics.

``confusion_matrix`` and ``confusion_accumulate`` count on the device: CUDA
tensors go through the hand-written kernel (``ops/cuda/confusion.py``), CPU
tensors through its plain PyTorch version. The derived measures are the
JAX package's ``ops/metrics.measures_from_confusion_matrix``, including the
exclusion of the void class 0 from total_accuracy and mean_IoU. ``auroc``
and ``roc_curve`` are host numpy: the JAX package's ``auroc``, and the
curve that ``sklearn.metrics.roc_curve`` gives, which the JAX package
imports and the port does not (sklearn is not a dependency of the port).
"""

import numpy as np

# [K, K] float32 per call, or counts added into a [K, K] int64 accumulator;
# rows = true class; labels < 0 (void) are not counted
from modular_semantic_segmentation_torch.ops.cuda.confusion import (  # noqa: F401,E501
    confusion_accumulate, confusion_counts, confusion_matrix)


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


def trapezoid(y, x):
    """Trapezoid-rule integral of y over x, numpy's formula (numpy 1.x
    calls it ``trapz``, 2.x ``trapezoid``)."""
    y, x = np.asarray(y, np.float64), np.asarray(x, np.float64)
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


def auroc(scores, labels):
    """Area under the ROC curve, the JAX package's formula: one step of
    the curve per sample, tied scores in their stable sorted order; NaN
    when only one class is present."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    if tps[-1] == 0 or fps[-1] == 0:
        return float("nan")
    tpr = np.concatenate([[0], tps / tps[-1]])
    fpr = np.concatenate([[0], fps / fps[-1]])
    return trapezoid(tpr, fpr)


def roc_curve(labels, scores):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve(labels,
    scores)`` gives them (``drop_intermediate=True``): one point per
    distinct score, highest first, collinear points dropped, a first point
    (0, 0) at threshold inf. A class that is absent makes its rate NaN.
    """
    labels = np.asarray(labels).ravel().astype(bool)
    scores = np.asarray(scores, np.float64).ravel()
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    last = np.r_[np.where(np.diff(scores))[0], labels.size - 1]
    tps = np.cumsum(labels, dtype=np.float64)[last]
    fps = 1 + last - tps
    thresholds = scores[last]
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds
