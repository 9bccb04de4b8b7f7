"""The AdapNet family: AdapNet experts and their Bayes fusion.

The same surface as ``models/simple_fcn.py``. AdapNet upsamples through
trainable dense transposed convolutions, so it has no frozen bilinear
upsampling (``upsample_calls`` is empty) and the benchmark does not train
it yet (no ``build_trainer``).
"""

import math

from benchmark.models.simple_fcn import _layer
from benchmark.reference import adapnet as ref

def _block_convs(kind, in_ch, widths, stride_or_rates, shortcut):
    """[(name, k, cin, cout, stride, dilation)] of one residual block."""
    if kind == "a":
        mid, out = widths
        s = stride_or_rates
        convs = [("stage_1", 1, in_ch, mid, s, 1),
                 ("stage_2", 3, mid, mid, 1, 1), ("stage_3", 1, mid, out, 1, 1)]
        if shortcut:
            convs.append(("shortcut", 1, in_ch, out, s, 1))
        return convs, out
    first, mid, out = widths
    convs = [("stage_1", 1, in_ch, first, 1, 1)]
    convs += [(f"stage_2_{i + 1}", 3, first, mid // 2, 1, rate)
              for i, rate in enumerate(stride_or_rates)]
    convs.append(("stage_3", 1, mid, out, 1, 1))
    if shortcut:
        convs.append(("shortcut", 1, in_ch, out, 1, 1))
    return convs, out


def _convs(config, in_channels):
    """Every convolution and transposed convolution of one expert, in the
    program's order: (scope, k, cin, cout, stride, dilation or 'deconv',
    has a bias)."""
    units, classes = config["num_units"], config["num_classes"]
    out = [("block_0_1", 3, in_channels, 64, 1, 1, True),
           ("block_0_2", 7, 64, 64, 2, 1, True)]
    width = 64
    for scope, kind, widths, sr, shortcut in ref.BLOCKS:
        convs, width_out = _block_convs(kind, width, widths, sr, shortcut)
        out += [(f"{scope}/{name}", k, cin, cout, s, d, False)
                for name, k, cin, cout, s, d in convs]
        width = width_out
        if scope == ref.SKIP_AFTER:
            out.append(("shortcut", 1, width, units, 1, 1, True))
    out.append(("first_deconvolution_conv", 1, width, 2048, 1, 1, True))
    out.append(("first_deconvolution_upconv", 4, 2048, units, 2, "deconv",
                False))
    out.append(("second_deconvolution_upconv", 16, units, classes, 8,
                "deconv", False))
    return out


def variable_specs(config, prefix, in_channels, batchnorm=True):
    """[(name, shape, kind)] of one expert, in the program's order."""
    specs = []
    for scope, k, cin, cout, _, d, bias in _convs(config, in_channels):
        if d == "deconv":
            specs += _layer(f"{prefix}/{scope}", (k, k, cout, cin), "deconv",
                            True, bias=False)
        else:
            specs += _layer(f"{prefix}/{scope}", (k, k, cin, cout), "kernel",
                            True, bias=bias)
    return specs


def expert_flops(config, height, width, in_channels):
    """FLOPs (2 per multiply-add) of one expert's convolutions at their
    output sizes (SAME: ceil(in / stride); the max pool after the stem
    halves, VALID) and of its two dense transposed convolutions (k * k
    multiply-adds per input pixel and pair of channels)."""
    units, classes = config["num_units"], config["num_classes"]
    total = 0

    def conv(k, cin, cout, h, w, stride=1):
        nonlocal total
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
        total += 2 * k * k * cin * cout * ho * wo
        return ho, wo

    h, w = conv(3, in_channels, 64, height, width)
    h, w = conv(7, 64, 64, h, w, 2)
    h, w, ch = h // 2, w // 2, 64
    for scope, kind, widths, stride_or_rates, shortcut in ref.BLOCKS:
        if kind == "a":
            mid, out = widths
            ho, wo = conv(1, ch, mid, h, w, stride_or_rates)
            conv(3, mid, mid, ho, wo)
            conv(1, mid, out, ho, wo)
            if shortcut:
                conv(1, ch, out, h, w, stride_or_rates)
        else:
            first, mid, out = widths
            ho, wo = conv(1, ch, first, h, w)
            for _ in stride_or_rates:
                conv(3, first, mid // 2, h, w)
            conv(1, mid, out, h, w)
            if shortcut:
                conv(1, ch, out, h, w)
        h, w, ch = ho, wo, out
        if scope == ref.SKIP_AFTER:
            conv(1, ch, units, h, w)
    conv(1, ch, 2048, h, w)
    total += 2 * 4 * 4 * 2048 * units * h * w
    total += 2 * 16 * 16 * units * classes * (2 * h) * (2 * w)
    return total


def fused_frame_flops(config):
    serve = config["serve"]
    h, w = serve["height"], serve["width"]
    experts = sum(expert_flops(config, h, w, ch)
                  for ch in config["modalities"].values())
    return experts + len(config["modalities"]) * config["num_classes"] * h * w


def upsample_calls(config):
    return []


def build_fusion(config, confusion_matrices, device, seed):
    from benchmark.models.simple_fcn import build_fusion as build
    return build(config, confusion_matrices, device, seed)


def reference_scores(weights, prefix, x, batchnorm=True, train=False):
    return ref.forward(weights, prefix, x, train=train)
