"""UncertaintyModel: uncertainty scoring on the Estimator runtime
(counterpart of the JAX package's ``models/uncertainty_model.py``).

The reference imports ``xview/models/uncertainty_model.py``, which is
missing from its repository; its API follows from the call sites
(experiments/uncertainty_eval.py:18-52, bayesian_fcn.py:3):

    * misclassification / out-of-distribution detection AUROC + ROC curves,
    * negative log-likelihood scoring,
    * per-pixel uncertainty value distributions,
    * calibration diagnostics (mean_diff, prob_distribution).

Subclasses provide ``_test_outputs`` that include per-pixel uncertainty
arrays (e.g. 'entropy', 'cond_entropy', 'variance') next to 'prob' and
'prediction'. The ROC curve and its area are the port's own numpy
(``ops/metrics.roc_curve``), equal to sklearn's, which the JAX package
calls.
"""

import warnings

import numpy as np

from modular_semantic_segmentation_torch.models.estimator import (
    Estimator, to_numpy)
from modular_semantic_segmentation_torch.ops import metrics as metrics_lib
from modular_semantic_segmentation_torch.ops.dirichlet_estimation import \
    dirichlet_mle_from_samples
from modular_semantic_segmentation_torch.utils.data_io import iterate_batches


class UncertaintyModel(Estimator):

    def _collect(self, data, keys):
        """Run the model over the data, collecting the requested output
        keys plus labels; the last batch is padded with label -1 and its
        padding dropped."""
        collected = {k: [] for k in keys}
        labels = []
        for batch, valid in iterate_batches(data, self.config["batchsize"]):
            out = self._forward(self._batch_to_device(batch))
            for k in keys:
                collected[k].append(to_numpy(out[k])[:valid])
            if "labels" in batch:
                labels.append(np.asarray(batch["labels"])[:valid])
        collected = {k: np.concatenate(v) for k, v in collected.items()}
        if labels:
            collected["labels"] = np.concatenate(labels)
        return collected

    # ------------------------------------------------------------ detection
    def _detection_score(self, uncertainty, positives, valid):
        """(fpr, tpr, auroc, thresholds) of the uncertainty as a detector
        of the positives. With one class present the area is NaN, with a
        warning, as sklearn's ``roc_auc_score`` gives it."""
        u = uncertainty[valid].ravel()
        y = positives[valid].ravel().astype(int)
        fpr, tpr, thresholds = metrics_lib.roc_curve(y, u)
        if len(np.unique(y)) != 2:
            warnings.warn("Only one class is present in y_true. ROC AUC "
                          "score is not defined in that case.")
            return fpr, tpr, float("nan"), thresholds
        return fpr, tpr, metrics_lib.trapezoid(tpr, fpr), thresholds

    def misclassification_detection_score(self, data, uncertainty_attr):
        """AUROC of the uncertainty metric for detecting misclassified
        pixels (reference uncertainty_eval.py:18-22)."""
        out = self._collect(data, ["prediction", uncertainty_attr])
        valid = out["labels"] >= 0
        wrong = out["prediction"] != out["labels"]
        return self._detection_score(out[uncertainty_attr], wrong, valid)

    def out_of_distribution_detection_score(self, data, uncertainty_attr):
        """AUROC for detecting OOD pixels; labels are the in(0)/out(1)
        mask of an OOD benchmark dataset."""
        out = self._collect(data, [uncertainty_attr])
        valid = out["labels"] >= 0
        ood = out["labels"] > 0
        return self._detection_score(out[uncertainty_attr], ood, valid)

    # -------------------------------------------------------------- scoring
    def nll_score(self, data):
        """Mean negative log-likelihood of the true class + class counts."""
        out = self._collect(data, ["prob"])
        labels = out["labels"]
        valid = labels >= 0
        num_classes = self.config["num_classes"]
        probs = out["prob"][valid]
        lab = labels[valid]
        nll = -np.mean(np.log(1e-20 + probs[np.arange(len(lab)), lab]))
        class_counts = np.bincount(lab, minlength=num_classes)
        return float(nll), class_counts

    def value_distribution(self, data, uncertainty_attr, bins=50):
        """Histogram (counts, bin edges) of the per-pixel uncertainty."""
        out = self._collect(data, [uncertainty_attr])
        values = out[uncertainty_attr]
        if "labels" in out:
            values = values[out["labels"] >= 0]
        counts, edges = np.histogram(values.ravel(), bins=bins)
        return {"counts": counts, "edges": edges,
                "mean": float(values.mean()), "std": float(values.std())}

    def mean_diff(self, data, prior, condition=None):
        """Mean absolute difference between the average predicted
        distribution and a given prior, over pixels selected by
        ``condition(labels, classes)`` (calibration check, reference
        uncertainty_eval.py:42-48)."""
        out = self._collect(data, ["prob"])
        labels = out["labels"]
        mask = labels >= 0
        if condition is not None:
            mask = np.logical_and(mask, condition(labels, labels))
        mean_prob = out["prob"][mask].mean(0)
        return float(np.abs(mean_prob - np.asarray(prior)).mean())

    def prob_distribution(self, data, max_samples=20000):
        """Fit a Dirichlet to the output probability vectors + mean output
        (reference uncertainty_eval.py:49-51)."""
        out = self._collect(data, ["prob"])
        probs = out["prob"].reshape(-1, self.config["num_classes"])
        if "labels" in out:
            probs = probs[out["labels"].ravel() >= 0]
        if len(probs) > max_samples:
            idx = np.random.RandomState(0).choice(len(probs), max_samples,
                                                  replace=False)
            probs = probs[idx]
        probs = np.clip(probs.astype(np.float64), 1e-10, 1.0)
        probs = probs / probs.sum(-1, keepdims=True)
        dirichlet = dirichlet_mle_from_samples(probs, maxiter=200)
        return dirichlet, probs.mean(0)
