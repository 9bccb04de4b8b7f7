"""Kernel A's two entry points, ``Estimator.score``, the ROC metrics and the
model registry of the port against the JAX package (and sklearn, which the
JAX package's ``UncertaintyModel`` calls), on the CPU.

Counts are exact: ``confusion_accumulate`` and ``score`` against the JAX
``ops/metrics.confusion_matrix`` summed over the same batches, with -1 and
out-of-range labels and predictions, a padded last batch and the one-bin
case. ``roc_curve`` equals sklearn's ``roc_curve`` element for element
(NaN where a class is absent) and its trapezoid area equals
``roc_auc_score``; ``auroc`` equals the JAX package's ``auroc`` (which
steps through ties one sample at a time, unlike sklearn). Model SMALL
size: SimpleFCN, ``num_units=8``, ``channel_factor=0.125``, 14 classes,
64x96 frames.
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from sklearn.metrics import roc_auc_score
from sklearn.metrics import roc_curve as sklearn_roc_curve

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import metrics as jmetrics
from modular_semantic_segmentation_torch.models import _REGISTRY
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.ops import metrics as tmetrics
from modular_semantic_segmentation_torch.ops.cuda import confusion

NUM_CLASSES = 14
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(kind, k=NUM_CLASSES):
    """Three (predictions, labels) int32 batches of unequal sizes."""
    rng = np.random.RandomState(4)
    out = []
    for shape in ((2, 30, 40), (1, 17, 9), (3, 5, 7)):
        if kind == "uniform":
            preds = rng.randint(-1, k + 2, shape)
            labels = rng.randint(-2, k + 3, shape)
        else:
            preds = np.full(shape, 5)
            labels = np.full(shape, 5)
        out.append((preds.astype(np.int32), labels.astype(np.int32)))
    return out


@pytest.mark.parametrize("kind", ["uniform", "one_bin"])
def test_confusion_accumulate_equals_jax_sum_over_batches(kind):
    k = NUM_CLASSES
    total = torch.zeros((k, k), dtype=torch.int64)
    want = np.zeros((k, k), np.float32)
    confusion.KERNEL.launches = 0
    for preds, labels in _batches(kind):
        tmetrics.confusion_accumulate(torch.from_numpy(preds),
                                      torch.from_numpy(labels), k, total)
        want = want + np.asarray(jmetrics.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(labels), k))
    assert confusion.KERNEL.launches == 0
    assert total.dtype == torch.int64
    np.testing.assert_array_equal(total.numpy().astype(np.float32), want)
    if kind == "one_bin":
        assert int(total[5, 5]) == int(total.sum()) > 0


def test_confusion_accumulate_refuses_a_wrong_accumulator():
    preds, labels = (torch.from_numpy(a) for a in _batches("uniform")[0])
    for total in (torch.zeros((14, 14)),
                  torch.zeros((14, 13), dtype=torch.int64),
                  torch.zeros((14, 28), dtype=torch.int64)[:, ::2]):
        with pytest.raises(ValueError, match="int64"):
            tmetrics.confusion_accumulate(preds, labels, 14, total)


def test_score_equals_jax_confusion_over_padded_batches():
    """``score`` over 3 frames at batch size 2: the last batch is padded
    with label -1; labels reach -1 and K + 1. The matrix equals the JAX
    confusion of the model's own predictions, summed frame by frame."""
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb", data_description=DATA_DESCRIPTION,
        num_units=8, channel_factor=0.125, batchsize=2, device="cpu")
    rng = np.random.RandomState(9)
    data = {"rgb": (rng.rand(3, 64, 96, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES + 2,
                                  (3, 64, 96)).astype(np.int32)}
    measures, got = net.score(data)
    preds = net.predict(data)
    want = sum(np.asarray(jmetrics.confusion_matrix(
        jnp.asarray(preds[i]), jnp.asarray(data["labels"][i]), NUM_CLASSES))
        for i in range(3))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    labelled = ((data["labels"] >= 0)
                & (data["labels"] < NUM_CLASSES)).sum()
    assert got.sum() == labelled
    assert measures["confusion_matrix"].sum() == labelled


def _roc_cases():
    rng = np.random.RandomState(11)
    labels = rng.rand(400) < 0.3
    return {
        "distinct": (labels, rng.rand(400)),
        "ties": (labels, np.round(rng.rand(400), 1)),
        "float32_ties": (labels, np.round(rng.rand(400), 2).astype(
            np.float32)),
        "only_negatives": (np.zeros(50, bool), rng.rand(50)),
        "only_positives": (np.ones(50, bool), np.round(rng.rand(50), 1)),
    }


@pytest.mark.parametrize("case", sorted(_roc_cases()))
def test_roc_curve_matches_sklearn(case):
    labels, scores = _roc_cases()[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn warns on one class
        want = sklearn_roc_curve(labels, scores)
    got = tmetrics.roc_curve(labels, scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    if 0 < labels.sum() < labels.size:
        assert tmetrics.trapezoid(got[1], got[0]) == roc_auc_score(labels,
                                                                   scores)


@pytest.mark.parametrize("case", sorted(_roc_cases()))
def test_auroc_matches_jax(case):
    labels, scores = _roc_cases()[case]
    got = tmetrics.auroc(scores, labels)
    want = jmetrics.auroc(scores, labels)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_registry_names_resolve_as_jax(name):
    assert get_model(name).__name__ == jax_model(name).__name__


def test_unknown_registry_name_raises_as_jax():
    for lookup in (get_model, jax_model):
        with pytest.raises(UserWarning, match="not found"):
            lookup("no_such_model")
