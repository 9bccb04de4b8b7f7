"""The VGG16 FCN expert of the paper (Blum et al., IROS 2018), after FCN-16s
(Long et al., CVPR 2015): the thirteen 3x3 convolutions of VGG16 with four
2x2 max pools, 1x1 score convolutions on conv4_3 and conv5_3, the coarser
score upsampled 2x by a frozen bilinear 4x4 transposed convolution and
added, then upsampled 8x by a frozen bilinear 16x16 transposed convolution
and scored by a 1x1 convolution into the classes.

Every convolution has a bias and is followed by ReLU, but the last one;
with batch norm it sits between the convolution and the ReLU, after each
transposed convolution too.
"""

import torch

from benchmark.reference.layers import Layers

VGG16 = (("conv1_1", 64), ("conv1_2", 64), "pool",
         ("conv2_1", 128), ("conv2_2", 128), "pool",
         ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "pool",
         ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "pool",
         ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512))


def forward(weights, prefix, x, batchnorm, train=False):
    """Class scores [N, K, H, W] of NCHW ``x``; returns (scores, the
    ``Layers`` object, which holds batch norm's moving updates)."""
    net = Layers(weights, train=train)
    taps = {}
    h = x
    for layer in VGG16:
        if layer == "pool":
            h = torch.nn.functional.max_pool2d(h, 2, 2)
            continue
        name, _ = layer
        h = net.conv(h, f"{prefix}/{name}", bn=batchnorm)
        taps[name] = h
    score4 = net.conv(taps["conv4_3"], f"{prefix}/score_conv4", bn=batchnorm)
    score5 = net.conv(taps["conv5_3"], f"{prefix}/score_conv5", bn=batchnorm)
    up5 = net.deconv(score5, f"{prefix}/upscore_conv5", 2, bn=batchnorm,
                     relu=True)
    up = net.deconv(score4 + up5, f"{prefix}/upscore", 8, bn=batchnorm,
                    relu=True)
    score = net.conv(up, f"{prefix}/score", bn=batchnorm, relu=False)
    return score, net
