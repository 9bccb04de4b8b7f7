"""AdapNet: a ResNet-50-style encoder with multi-scale dilated blocks
(counterpart of the JAX package's ``models/adapnet.py``; Valada et al.,
ICRA 2017).

Block B splits the middle 3x3 into two parallel atrous convolutions of
different dilation rates, concatenated. Every conv has batch norm; the
blocks' convs have no bias. Upsampling is two-stage (x2, then x8) through
transposed convolutions that start from the bilinear kernel and TRAIN, so
they take ``deconv2d``'s dense ``conv_transpose2d``. ``adapnet`` is a
plain function returning its layer dict, so the fusion models build
AdapNet experts without expert model objects; ``adapnet_variable_specs``
lists what it reads under the JAX package's names.
"""

import torch

from modular_semantic_segmentation_torch.ops import init as initializers
from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.init import layer_specs
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.models.estimator import Estimator

_BLOCK_CONV = {"batch_normalization": True, "use_bias": False}


def block_a(ctx, inputs, intermed_filters, filters, strides, name,
            shortcut_conv=False, activation=torch.relu):
    """Bottleneck 1x1-3x3-1x1 residual block."""
    with ctx.scope(name):
        stage_1 = ll.conv2d(ctx, inputs, intermed_filters, 1, "stage_1",
                            strides=strides, **_BLOCK_CONV)
        stage_2 = ll.conv2d(ctx, stage_1, intermed_filters, 3, "stage_2",
                            **_BLOCK_CONV)
        stage_3 = ll.conv2d(ctx, stage_2, filters, 1, "stage_3",
                            **_BLOCK_CONV)
        shortcut = (ll.conv2d(ctx, inputs, filters, 1, "shortcut",
                              strides=strides, **_BLOCK_CONV)
                    if shortcut_conv else inputs)
    return activation(stage_3 + shortcut)


def block_b(ctx, inputs, filters_1, filters_2, filters_3, dilation1,
            dilation2, name, shortcut_conv=False, activation=torch.relu):
    """Residual block whose middle 3x3 is two parallel atrous convs."""
    with ctx.scope(name):
        stage_1 = ll.conv2d(ctx, inputs, filters_1, 1, "stage_1",
                            **_BLOCK_CONV)
        stage_2 = torch.cat([
            ll.conv2d(ctx, stage_1, filters_2 // 2, 3, f"stage_2_{i + 1}",
                      dilation_rate=rate, **_BLOCK_CONV)
            for i, rate in enumerate((dilation1, dilation2))], dim=-1)
        stage_3 = ll.conv2d(ctx, stage_2, filters_3, 1, "stage_3",
                            **_BLOCK_CONV)
        shortcut = (ll.conv2d(ctx, inputs, filters_3, 1, "shortcut",
                              **_BLOCK_CONV)
                    if shortcut_conv else inputs)
    return activation(stage_3 + shortcut)


# the 16 residual blocks: (layer key, scope, block, its widths, strides or
# dilations, shortcut conv)
BLOCKS = (
    ("block_1", "block_layer_1", block_a, (64, 256, 1), True),
    ("block_2", "block_layer_2", block_a, (64, 256, 1), False),
    ("block_3", "block_layer_3", block_a, (64, 256, 1), False),
    ("block_4", "block_layer_4", block_a, (128, 512, 2), True),
    ("block_5", "block_layer_5", block_a, (128, 512, 1), False),
    ("block_6", "block_layer_6", block_a, (128, 512, 1), False),
    ("block_7", "block_layer_7", block_b, (128, 64, 512, 1, 2), False),
    ("block_8", "block_layer_8", block_a, (256, 1024, 2), True),
    ("block_9", "block_layer_9", block_a, (256, 1024, 1), False),
    ("block_10", "block_layer_10", block_b, (256, 256, 1024, 1, 2), False),
    ("block_11", "block_layer_11", block_b, (256, 256, 1024, 1, 4), False),
    ("block_12", "block_layer_12", block_b, (256, 256, 1024, 1, 8), False),
    ("block_13", "block_layer_13", block_b, (256, 256, 1024, 1, 16),
     False),
    ("block_14", "block_layer_14", block_b, (512, 512, 2048, 2, 4), True),
    ("block_15", "block_layer_15", block_b, (512, 512, 2048, 2, 8), False),
    ("block_16", "block_layer_16", block_b, (512, 512, 2048, 2, 16),
     False),
)
# the mid-network skip taps this block
SKIP_BLOCK = "block_7"


def adapnet(ctx, inputs, prefix, num_units, num_classes):
    """The AdapNet graph: stem, 16 blocks with dilations up to 16, the
    skip from block 7, two-stage deconvolution. Returns the layer dict;
    'score' is the class score map."""
    params = {"batch_normalization": True}
    with ctx.scope(prefix):
        l = {}
        l["block_0_1"] = ll.conv2d(ctx, inputs, 64, 3, "block_0_1", **params)
        l["block_0_2"] = ll.conv2d(ctx, l["block_0_1"], 64, 7, "block_0_2",
                                   strides=2, **params)
        l["block_0_pool"] = ll.max_pool2d(ctx, l["block_0_2"], 2, 2)
        x = l["block_0_pool"]
        for key, scope, block, args, shortcut in BLOCKS:
            x = l[key] = block(ctx, x, *args, scope, shortcut_conv=shortcut)
            if key == SKIP_BLOCK:
                l["shortcut"] = ll.conv2d(ctx, x, num_units, 1, "shortcut",
                                          activation=None, **params)
        deconv_1 = ll.conv2d(ctx, x, 2048, 1, "first_deconvolution_conv",
                             **params)
        l["deconv_1"] = ll.deconv2d(ctx, deconv_1, num_units, 4,
                                    "first_deconvolution_upconv", strides=2,
                                    trainable=True, **params)
        l["merge"] = l["deconv_1"] + l["shortcut"]
        l["score"] = ll.deconv2d(ctx, l["merge"], num_classes, 16,
                                 "second_deconvolution_upconv", strides=8,
                                 trainable=True, **params)
    return l


def _block_specs(scope, block, in_ch, args, shortcut):
    """(specs of one residual block, its output width)."""
    if block is block_a:
        mid, out = args[:2]
        convs = [("stage_1", 1, in_ch, mid), ("stage_2", 3, mid, mid),
                 ("stage_3", 1, mid, out)]
    else:
        first, half, out = args[0], args[1] // 2, args[2]
        convs = [("stage_1", 1, in_ch, first), ("stage_2_1", 3, first, half),
                 ("stage_2_2", 3, first, half), ("stage_3", 1, 2 * half, out)]
    if shortcut:
        convs.append(("shortcut", 1, in_ch, out))
    specs = []
    for name, k, cin, cout in convs:
        specs += layer_specs(f"{scope}/{name}", (k, k, cin, cout), cout,
                             batchnorm=True, bias=False)
    return specs, out


def adapnet_variable_specs(prefix, in_channels, num_units, num_classes):
    """[(name, shape, initializer, trainable)] of every variable
    :func:`adapnet` reads. Every kernel and bias trains, the two deconv
    kernels included (from the bilinear initializer); BN's moving
    statistics do not."""
    specs = (layer_specs(f"{prefix}/block_0_1", (3, 3, in_channels, 64), 64,
                         batchnorm=True)
             + layer_specs(f"{prefix}/block_0_2", (7, 7, 64, 64), 64,
                           batchnorm=True))
    width = 64
    for key, scope, block, args, shortcut in BLOCKS:
        block_specs, width = _block_specs(f"{prefix}/{scope}", block, width,
                                          args, shortcut)
        specs += block_specs
        if key == SKIP_BLOCK:
            specs += layer_specs(f"{prefix}/shortcut",
                                 (1, 1, width, num_units), num_units,
                                 batchnorm=True)
    bilinear = initializers.bilinear_filter_initializer
    return (specs
            + layer_specs(f"{prefix}/first_deconvolution_conv",
                          (1, 1, width, 2048), 2048, batchnorm=True)
            + layer_specs(f"{prefix}/first_deconvolution_upconv",
                          (4, 4, num_units, 2048), num_units, batchnorm=True,
                          bias=False, kernel_init=bilinear)
            + layer_specs(f"{prefix}/second_deconvolution_upconv",
                          (16, 16, num_classes, num_units), num_classes,
                          batchnorm=True, bias=False, kernel_init=bilinear))


class Adapnet(Estimator):
    """AdapNet expert model.

    Args:
        data_description: tuple from dataset.get_data_description().
        prefix: variable-name prefix (default: the modality).
        config: ``modality``, ``num_units`` and the Estimator's keys.

    The training loss is the pixel-normalized cross entropy, as the JAX
    package's (the reference divides it by the label count a second
    time). int8 serving is not ported for AdapNet:
    ``quantize_for_serving`` raises.
    """

    def __init__(self, data_description, prefix=None, output_dir=None,
                 **config):
        self.prefix = prefix if prefix is not None else config["modality"]
        Estimator.__init__(self, data_description, output_dir=output_dir,
                           **config)

    def _variable_specs(self):
        return adapnet_variable_specs(
            self.prefix, self._input_channels(self.config["modality"]),
            self.config["num_units"], self.config["num_classes"])

    def _score(self, ctx, batch):
        return adapnet(ctx, batch[self.config["modality"]], self.prefix,
                       self.config["num_units"],
                       self.config["num_classes"])["score"]

    def _train_outputs(self, ctx, batch):
        log_prob = ll.log_softmax(self._score(ctx, batch))
        return {"loss": cross_entropy(log_prob, batch["labels"],
                                      axis_name=ctx.sharded_axes)}

    def _test_outputs(self, ctx, batch):
        prob = ll.softmax(self._score(ctx, batch))
        return {"prob": prob,
                "prediction": prob.argmax(-1).to(torch.int32)}
