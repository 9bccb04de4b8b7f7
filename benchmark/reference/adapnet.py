"""AdapNet (Valada et al., ICRA 2017) as the paper's code builds it: a
ResNet-50-style encoder whose later blocks split the middle 3x3 into two
parallel atrous convolutions, a 1x1 skip from the seventh block, and two
trainable transposed convolutions (2x, then 8x).

Every convolution has batch norm and ReLU; the residual blocks' have no
bias, and each block adds its shortcut and applies ReLU again. The skip's
1x1 and the two transposed convolutions have batch norm and no ReLU.
"""

import torch

from benchmark.reference.layers import Layers

# (scope, kind, widths, stride or dilations, shortcut conv)
BLOCKS = (
    ("block_layer_1", "a", (64, 256), 1, True),
    ("block_layer_2", "a", (64, 256), 1, False),
    ("block_layer_3", "a", (64, 256), 1, False),
    ("block_layer_4", "a", (128, 512), 2, True),
    ("block_layer_5", "a", (128, 512), 1, False),
    ("block_layer_6", "a", (128, 512), 1, False),
    ("block_layer_7", "b", (128, 64, 512), (1, 2), False),
    ("block_layer_8", "a", (256, 1024), 2, True),
    ("block_layer_9", "a", (256, 1024), 1, False),
    ("block_layer_10", "b", (256, 256, 1024), (1, 2), False),
    ("block_layer_11", "b", (256, 256, 1024), (1, 4), False),
    ("block_layer_12", "b", (256, 256, 1024), (1, 8), False),
    ("block_layer_13", "b", (256, 256, 1024), (1, 16), False),
    ("block_layer_14", "b", (512, 512, 2048), (2, 4), True),
    ("block_layer_15", "b", (512, 512, 2048), (2, 8), False),
    ("block_layer_16", "b", (512, 512, 2048), (2, 16), False),
)
SKIP_AFTER = "block_layer_7"


def _block(net, x, scope, kind, stride_or_rates, shortcut):
    conv = dict(bias=False, bn=True)
    if kind == "a":
        s = stride_or_rates
        h = net.conv(x, f"{scope}/stage_1", stride=s, **conv)
        h = net.conv(h, f"{scope}/stage_2", **conv)
        h = net.conv(h, f"{scope}/stage_3", **conv)
        short = (net.conv(x, f"{scope}/shortcut", stride=s, **conv)
                 if shortcut else x)
    else:
        h = net.conv(x, f"{scope}/stage_1", **conv)
        h = torch.cat([net.conv(h, f"{scope}/stage_2_{i + 1}",
                                dilation=rate, **conv)
                       for i, rate in enumerate(stride_or_rates)], dim=1)
        h = net.conv(h, f"{scope}/stage_3", **conv)
        short = net.conv(x, f"{scope}/shortcut", **conv) if shortcut else x
    return torch.relu(h + short)


def forward(weights, prefix, x, train=False):
    """Class scores [N, K, H, W] of NCHW ``x``; returns (scores, the
    ``Layers`` object)."""
    net = Layers(weights, train=train)
    h = net.conv(x, f"{prefix}/block_0_1", bn=True)
    h = net.conv(h, f"{prefix}/block_0_2", stride=2, bn=True)
    h = torch.nn.functional.max_pool2d(h, 2, 2)
    skip = None
    for scope, kind, _, stride_or_rates, shortcut in BLOCKS:
        h = _block(net, h, f"{prefix}/{scope}", kind, stride_or_rates,
                   shortcut)
        if scope == SKIP_AFTER:
            skip = net.conv(h, f"{prefix}/shortcut", bn=True, relu=False)
    h = net.conv(h, f"{prefix}/first_deconvolution_conv", bn=True)
    h = net.deconv(h, f"{prefix}/first_deconvolution_upconv", 2, bn=True)
    score = net.deconv(h + skip, f"{prefix}/second_deconvolution_upconv", 8,
                       bn=True)
    return score, net
