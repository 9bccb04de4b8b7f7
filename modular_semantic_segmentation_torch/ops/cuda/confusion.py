"""Confusion-matrix accumulation: ``csrc/confusion.cu`` and its plain twins.

Port of the JAX package's ``ops/pallas/confusion_kernel.confusion_matrix``
(and of the XLA form in ``ops/metrics.confusion_matrix``, which computes
the same function).

    * :func:`confusion_accumulate` adds a batch's counts into a [K, K]
      int64 accumulator that the caller owns: one launch, no zeroing,
      slicing or casting pass per batch (``Estimator.score``);
    * :func:`confusion_matrix` is the drop-in counterpart of the JAX
      function, [K, K] float32 per call, through the registered operator
      ``msstorch::confusion_counts`` (``torch.export`` records it; an
      exported program that loads ``ops/cuda/library.py`` reaches the
      kernel).
"""

import ctypes

import torch

from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

#: each warp's K*K 32-bit bins share the 48 KB of shared memory a block
#: gets without opting in; at K = 100 (40,000 bytes) the block's warps
#: share one copy
MAX_CLASSES = 100

KERNEL = Kernel("confusion", "confusion_accumulate_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _one_hot_counts(predictions, labels, num_classes, dtype):
    preds = predictions.reshape(-1).long()
    labs = labels.reshape(-1).long()
    labs = torch.where(labs < 0, num_classes, labs)
    lab_classes = torch.arange(num_classes + 1, device=labs.device)
    pred_classes = torch.arange(num_classes, device=preds.device)
    lab_oh = (labs[:, None] == lab_classes[None, :]).to(dtype)
    pred_oh = (preds[:, None] == pred_classes[None, :]).to(dtype)
    return (lab_oh.T @ pred_oh)[:num_classes]


def confusion_matrix_plain(predictions, labels, num_classes):
    """The plain PyTorch version: the JAX package's one-hot contraction.

    Labels < 0 go to an extra row that is dropped; a label above K or a
    prediction outside [0, K) matches no one-hot column and counts
    nowhere. Returns [K, K] float32, rows = true class. The sums of 0/1
    products are exact in float32 up to 2**24 per bin.
    """
    return _one_hot_counts(predictions, labels, num_classes, torch.float32)


def confusion_counts_plain(predictions, labels, num_classes):
    """:func:`confusion_matrix_plain` as [K, K] int64 counts: the same
    contraction in float64, exact up to 2**53 per bin."""
    return _one_hot_counts(predictions, labels, num_classes,
                           torch.float64).long()


def _flat_int32(predictions, labels, num_classes):
    """Validated flat int32 views of the inputs for the kernel."""
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}]")
    if predictions.numel() != labels.numel():
        raise ValueError("predictions and labels differ in size")
    # the port's labels and predictions are int32 already, and for them
    # neither line below makes a pass; other integer types are cast
    return (predictions.reshape(-1).to(torch.int32).contiguous(),
            labels.reshape(-1).to(torch.int32).contiguous())


def _device_type(predictions, labels):
    if predictions.device != labels.device:
        raise ValueError("predictions and labels are on different devices "
                         f"({predictions.device}, {labels.device})")
    if predictions.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {predictions.device}")
    return predictions.device.type


def confusion_accumulate(predictions, labels, num_classes, total):
    """Add the counts of a batch into ``total`` in place; returns it.

    ``total`` is [K, K] int64, rows = true class, on the device of the
    inputs; the counts are the function of :func:`confusion_matrix_plain`
    and exact. CPU tensors take :func:`confusion_counts_plain`; CUDA
    tensors launch the kernel once, or raise.
    """
    kind = _device_type(predictions, labels)
    k = int(num_classes)
    if (total.dtype != torch.int64 or tuple(total.shape) != (k, k)
            or not total.is_contiguous()
            or total.device != predictions.device):
        raise ValueError(f"total must be a contiguous [{k}, {k}] int64 "
                         f"tensor on {predictions.device}")
    if kind == "cpu":
        total += confusion_counts_plain(predictions, labels, k)
        return total
    preds, labs = _flat_int32(predictions, labels, k)
    if preds.numel():
        with torch.cuda.device(preds.device):
            KERNEL(preds.data_ptr(), labs.data_ptr(), preds.numel(), k,
                   total.data_ptr(),
                   torch.cuda.current_stream(preds.device).cuda_stream)
    return total


def confusion_counts(predictions, labels, num_classes):
    """[K, K] int64 counts of a batch, rows = true class, through the
    registered operator ``msstorch::confusion_counts`` (which
    ``torch.export`` records): CPU tensors take
    :func:`confusion_counts_plain`; CUDA tensors launch the kernel into a
    fresh accumulator, or raise."""
    _device_type(predictions, labels)  # before the fake implementation
    return torch.ops.msstorch.confusion_counts(predictions, labels,
                                               int(num_classes))


def confusion_matrix(predictions, labels, num_classes):
    """[K, K] float32 confusion matrix, rows = true class: the counts of
    :func:`confusion_counts`."""
    return confusion_counts(predictions, labels, num_classes).float()


@torch.library.custom_op("msstorch::confusion_counts", mutates_args=())
def _confusion_counts_op(predictions: torch.Tensor, labels: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """[K, K] int64 counts of a batch (:func:`confusion_accumulate` into
    zeros)."""
    total = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                        device=predictions.device)
    return confusion_accumulate(predictions, labels, num_classes, total)


@_confusion_counts_op.register_fake
def _(predictions, labels, num_classes):
    return predictions.new_empty((num_classes, num_classes),
                                 dtype=torch.int64)
