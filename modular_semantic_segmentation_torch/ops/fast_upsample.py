"""The frozen bilinear transposed convolutions.

The JAX package's ``ops/fast_upsample.diagonal_upsample`` phase-decomposes
the channel-diagonal transposed convolution into a few shifted taps for the
TPU. The port computes the same phase decomposition as a gather: on the
card the hand-written kernel pair of ``csrc/upsample.cu`` (forward and its
adjoint), on the CPU their plain twins; both live in
``ops/cuda/upsample.py``, whose functions this module names.
"""

from modular_semantic_segmentation_torch.ops.cuda.upsample import (  # noqa
    diagonal_upsample, same_transpose_crop)
