"""The frozen bilinear transposed convolutions, as a depthwise
``conv_transpose2d``.

The JAX package's ``ops/fast_upsample.diagonal_upsample`` phase-decomposes
the channel-diagonal transposed convolution into a few shifted taps for the
TPU. Here it is the same function written as what it is: a depthwise
(``groups=C``) transposed convolution, followed by the crop that TF's SAME
padding implies (out = in * stride).
"""

import torch.nn.functional as F


def same_transpose_crop(kernel, stride):
    """Leading crop of a full transposed conv for TF SAME padding with
    out = in * stride: the forward conv's leading pad, (k - s) // 2."""
    return max(kernel - stride, 0) // 2


def diagonal_upsample(x, diag_kernel, stride):
    """Transposed-conv upsampling with a channel-diagonal kernel.

    Args:
        x: [N, H, W, C] input.
        diag_kernel: [k, k, C], the per-channel 2-D kernels (the diagonal
            of the dense [k, k, C, C] transposed-conv kernel).
        stride: upsampling factor s.
    Returns:
        [N, H*s, W*s, C] in ``x.dtype``, equal to TF ``conv2d_transpose``
        with SAME padding and the dense diagonal kernel.
    """
    k = int(diag_kernel.shape[0])
    s = int(stride)
    n, h, w, c = x.shape
    # [k, k, C] -> conv_transpose2d weight [C_in, C_out / groups, k, k]
    weight = diag_kernel.permute(2, 0, 1).unsqueeze(1).to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=s,
                             groups=c)
    lo = same_transpose_crop(k, s)
    out = out[:, :, lo:lo + h * s, lo:lo + w * s]
    return out.permute(0, 2, 3, 1)
