"""Confusion-matrix accumulation: ``csrc/confusion.cu`` and its plain twin.

Port of the JAX package's ``ops/pallas/confusion_kernel.confusion_matrix``
(and of the XLA form in ``ops/metrics.confusion_matrix``, which computes
the same function).
"""

import ctypes

import torch

from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

#: (K+1)*K int32 bins must fit the 48 KB of shared memory a block gets
#: without opting in
MAX_CLASSES = 100

KERNEL = Kernel("confusion", "confusion_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def confusion_matrix_plain(predictions, labels, num_classes):
    """The plain PyTorch version: the JAX package's one-hot contraction.

    Labels < 0 go to an extra row that is dropped; a label above K or a
    prediction outside [0, K) matches no one-hot column and counts
    nowhere. Returns [K, K] float32, rows = true class. The sums of 0/1
    products are exact in float32 up to 2**24 per bin.
    """
    preds = predictions.reshape(-1).long()
    labs = labels.reshape(-1).long()
    labs = torch.where(labs < 0, num_classes, labs)
    lab_classes = torch.arange(num_classes + 1, device=labs.device)
    pred_classes = torch.arange(num_classes, device=preds.device)
    lab_oh = (labs[:, None] == lab_classes[None, :]).float()
    pred_oh = (preds[:, None] == pred_classes[None, :]).float()
    return (lab_oh.T @ pred_oh)[:num_classes]


def confusion_matrix(predictions, labels, num_classes):
    """[K, K] float32 confusion matrix, rows = true class.

    CPU tensors take :func:`confusion_matrix_plain`; CUDA tensors launch
    the kernel, or raise.
    """
    if predictions.device != labels.device:
        raise ValueError("predictions and labels are on different devices "
                         f"({predictions.device}, {labels.device})")
    if predictions.device.type == "cpu":
        return confusion_matrix_plain(predictions, labels, num_classes)
    if predictions.device.type != "cuda":
        raise ValueError(f"unsupported device {predictions.device}")
    k = int(num_classes)
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}]")
    if predictions.numel() != labels.numel():
        raise ValueError("predictions and labels differ in size")
    # the port's labels and predictions are int32 already, and for them
    # neither line below makes a pass; other integer types are cast
    preds = predictions.reshape(-1).to(torch.int32).contiguous()
    labs = labels.reshape(-1).to(torch.int32).contiguous()
    out = torch.zeros((k + 1) * k, dtype=torch.int32, device=preds.device)
    if preds.numel():
        with torch.cuda.device(preds.device):
            KERNEL(preds.data_ptr(), labs.data_ptr(), preds.numel(), k,
                   out.data_ptr(),
                   torch.cuda.current_stream(preds.device).cuda_stream)
    return out[:k * k].view(k, k).float()
