"""Plain layers of the reference networks, NCHW, in the dtype they are given.

Written from the published definitions, not from the measured program:
TensorFlow 1 layer semantics, which the paper's code used.

* SAME padding: ``out = ceil(in / stride)``; the total pad is
  ``(out - 1) * stride + dilation * (k - 1) + 1 - in``, and the odd pixel
  goes to the trailing side.
* Transposed convolution (``conv2d_transpose``) with SAME padding gives
  ``out = in * stride``: the full transposed convolution, cropped by
  ``(k - stride) // 2`` at the leading side. Its kernel is stored
  ``[kh, kw, out, in]``; a convolution kernel is stored ``[kh, kw, in, out]``.
* Batch normalization: epsilon 1e-3, momentum 0.99, the biased batch
  variance in training.
* The frozen upsampling kernel is bilinear interpolation, one 2-D filter on
  each channel's diagonal entry (FCN, Long et al. 2015).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99


def same_pads(size, kernel, stride=1, dilation=1):
    """(leading, trailing) SAME pad of one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + dilation * (kernel - 1) + 1 - size, 0)
    return total // 2, total - total // 2


def conv(x, kernel_hwio, bias=None, stride=1, dilation=1):
    """SAME convolution of NCHW ``x`` with an HWIO kernel."""
    kh, kw = kernel_hwio.shape[:2]
    top, bottom = same_pads(x.shape[2], kh, stride, dilation)
    left, right = same_pads(x.shape[3], kw, stride, dilation)
    x = F.pad(x, (left, right, top, bottom))
    out = F.conv2d(x, kernel_hwio.permute(3, 2, 0, 1), stride=stride,
                   dilation=dilation)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def conv_transpose(x, kernel_hwoi, stride):
    """SAME transposed convolution (``out = in * stride``) with a
    ``[kh, kw, out, in]`` kernel."""
    k = kernel_hwoi.shape[0]
    h, w = x.shape[2], x.shape[3]
    full = F.conv_transpose2d(x, kernel_hwoi.permute(3, 2, 0, 1),
                              stride=stride)
    lo = max(k - stride, 0) // 2
    return full[:, :, lo:lo + h * stride, lo:lo + w * stride]


def batch_norm_eval(x, gamma, beta, mean, var):
    scale = gamma / torch.sqrt(var + BN_EPSILON)
    return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) \
        + beta.view(1, -1, 1, 1)


def batch_norm_train(x, gamma, beta):
    """Normalized ``x`` from its batch statistics, and those statistics
    (mean, biased variance) for the moving averages."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    out = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(
        var.view(1, -1, 1, 1) + BN_EPSILON)
    return out * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1), mean, var


def bilinear_kernel(kernel, channels):
    """The frozen ``[k, k, C, C]`` bilinear upsampling kernel, float32
    numpy: ``(1 - |y / f - c|) * (1 - |x / f - c|)`` on the diagonal, with
    ``f = ceil(k / 2)`` and ``c = (2f - 1 - f mod 2) / (2f)``."""
    factor = math.ceil(kernel / 2.0)
    center = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    og = np.arange(kernel)
    filt = np.outer(1 - np.abs(og / factor - center),
                    1 - np.abs(og / factor - center))
    out = np.zeros((kernel, kernel, channels, channels), np.float32)
    out[:, :, np.arange(channels), np.arange(channels)] = filt[:, :, None]
    return out


class Layers:
    """Applies named layers from a ``{tf_name: tensor}`` weight dict.

    ``train=False``: batch norm from the moving statistics. ``train=True``:
    from the batch's, with the moving statistics' updates collected in
    ``self.moving``.
    """

    def __init__(self, weights, train=False):
        self.w = weights
        self.train = train
        self.moving = {}

    def bn(self, x, scope):
        w = self.w
        if not self.train:
            return batch_norm_eval(x, w[f"{scope}/gamma"], w[f"{scope}/beta"],
                                   w[f"{scope}/moving_mean"],
                                   w[f"{scope}/moving_variance"])
        out, mean, var = batch_norm_train(x, w[f"{scope}/gamma"],
                                          w[f"{scope}/beta"])
        for key, value in (("moving_mean", mean), ("moving_variance", var)):
            name = f"{scope}/{key}"
            self.moving[name] = (BN_MOMENTUM * w[name]
                                 + (1 - BN_MOMENTUM) * value.detach())
        return out

    def conv(self, x, scope, stride=1, dilation=1, bias=True, bn=False,
             relu=True):
        """conv (+ bias) -> [batch norm] -> [ReLU]."""
        out = conv(x, self.w[f"{scope}/kernel"],
                   self.w[f"{scope}/bias"] if bias else None, stride,
                   dilation)
        if bn:
            out = self.bn(out, scope)
        return torch.relu(out) if relu else out

    def deconv(self, x, scope, stride, bn=False, relu=False):
        """transposed conv -> [batch norm] -> [ReLU]; no bias."""
        out = conv_transpose(x, self.w[f"{scope}/kernel"], stride)
        if bn:
            out = self.bn(out, scope)
        return torch.relu(out) if relu else out

