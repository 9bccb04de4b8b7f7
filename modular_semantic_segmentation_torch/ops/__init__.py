"""Functional layers, losses and metrics of the port (counterpart of the
JAX package's ``ops/__init__.py``, under its names; the port builds
variables from specs, ``ops/init.build_variables``, where the JAX package
exports ``init_variables``)."""

from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.ops.layers import (
    conv2d, deconv2d, max_pool2d, dropout, adap_conv,
    log_softmax, softmax, entropy, max_pool_with_argmax, unpool_2d,
)
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.ops.metrics import (
    confusion_matrix, measures_from_confusion_matrix,
)

__all__ = [
    "Ctx",
    "conv2d", "deconv2d", "max_pool2d", "dropout", "adap_conv",
    "log_softmax", "softmax", "entropy", "max_pool_with_argmax",
    "unpool_2d",
    "cross_entropy", "confusion_matrix", "measures_from_confusion_matrix",
]
