"""The kernels' registered operators, for programs made by ``torch.export``.

``torch.export`` cannot trace a ctypes call, so the kernels that a served
program reaches are PyTorch operators in the ``msstorch`` namespace,
registered with ``torch.library.custom_op`` where their wrappers live:

    * ``msstorch::dirichlet_label`` (``ops/cuda/dirichlet.py``, kernel B);
    * ``msstorch::confusion_counts`` (``ops/cuda/confusion.py``, kernel A);
    * ``msstorch::diagonal_upsample`` (``ops/cuda/upsample.py``, kernel
      D, the frozen bilinear upsample; its gradient launches the adjoint
      kernel).

Each launches its kernel for CUDA tensors and runs the kernel's plain
version for CPU tensors; a fake implementation gives ``torch.export`` the
output's shape. The stem conv probe's kernel (``ops/cuda/stem_conv.py``)
is on no exported path and is not registered. Importing this module
registers the operators; a program that names one of them loads only
after that (``serving.ExportedServing`` imports it first), and
``torch.export.load`` raises without it.
"""

from modular_semantic_segmentation_torch.ops.cuda import (  # noqa: F401
    confusion, dirichlet, upsample)
