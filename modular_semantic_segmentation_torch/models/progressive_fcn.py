"""ProgressiveFCN (counterpart of the JAX package's
``models/progressive_fcn.py``).

A new modality column (progressive networks, arXiv 1606.04671) trains
with lateral adapter connections from earlier, FROZEN VGG16 columns: the
lateral columns' kernels and biases do not train, the new column and its
adapters (scales and convs) do. Names follow the flat
``{prefix}_convX_Y/...`` VGG16 convention, so columns can be warm-started
from exported expert npz files.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.init import layer_specs
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.models.estimator import Estimator
from modular_semantic_segmentation_torch.models.simple_fcn import (
    bilinear_deconv_specs, decoder, decoder_variable_specs)
from modular_semantic_segmentation_torch.models.vgg16 import (
    progressive_vgg16, progressive_vgg16_variable_specs, vgg16,
    vgg16_variable_specs)


def progressive_fcn(ctx, batch, prefix, modality, lateral_columns, num_units,
                    num_classes, batchnorm=False, adapter_params=None):
    """The progressive FCN graph: the lateral VGG16 columns
    (``lateral_columns`` {prefix: modality}), the adapter-coupled new
    column, the FCN skip head and the decoder. Returns the layer dict
    ('score')."""
    params = {"batch_normalization": batchnorm}
    columns = {}
    for lat_prefix, lat_modality in lateral_columns.items():
        col = vgg16(ctx, batch[lat_modality], lat_prefix, params)
        for layer, value in col.items():
            columns.setdefault(layer, []).append(value)
    l = progressive_vgg16(ctx, batch[modality], columns, prefix, params,
                          adapter_params or {})
    score_conv4 = ll.conv2d(ctx, l["conv4_3"], num_units, 1,
                            f"{prefix}_score_conv4", **params)
    score_conv5 = ll.conv2d(ctx, l["conv5_3"], num_units, 1,
                            f"{prefix}_score_conv5", **params)
    upscore_conv5 = ll.deconv2d(ctx, score_conv5, num_units, 4,
                                f"{prefix}_upscore_conv5", strides=2,
                                activation=torch.relu,
                                batch_normalization=batchnorm)
    l["fused"] = score_conv4 + upscore_conv5
    l.update(decoder(ctx, l["fused"], prefix, num_units, num_classes,
                     batchnorm=batchnorm))
    return l


def progressive_fcn_variable_specs(prefix, in_channels, lateral_channels,
                                   num_units, num_classes, batchnorm=False,
                                   adapter_params=None):
    """Specs of the variables :func:`progressive_fcn` reads;
    ``lateral_channels`` {prefix: input channels} of the lateral columns,
    whose kernels and biases are frozen."""
    specs = []
    for lat_prefix, channels in lateral_channels.items():
        specs += vgg16_variable_specs(lat_prefix, channels, batchnorm,
                                      trainable=False)
    specs += progressive_vgg16_variable_specs(
        prefix, in_channels, len(lateral_channels), batchnorm,
        **(adapter_params or {}))
    for k in (4, 5):
        specs += layer_specs(f"{prefix}_score_conv{k}", (1, 1, 512, num_units),
                             num_units, batchnorm)
    return (specs
            + bilinear_deconv_specs(f"{prefix}_upscore_conv5", 4, num_units,
                                    batchnorm)
            + decoder_variable_specs(prefix, num_units, num_classes,
                                     batchnorm))


class ProgressiveFCN(Estimator):
    """Progressive-networks FCN.

    Config:
        prefix/modality: the new column being trained.
        lateral_columns: {prefix: modality} of the frozen trained columns.
        adapter: optional dict(extra_convolution, initial_scales,
            initialize_half_zero) for the adapter blocks.
        batch_normalization: default False.
    """

    # the VGG16 stack: no int8 spatial floor, as SimpleFCN
    ptq_min_pixels = 0

    def __init__(self, data_description, prefix=None, output_dir=None,
                 **config):
        standard_config = {"batch_normalization": False,
                           "lateral_columns": {}, "adapter": {}}
        standard_config.update(config)
        self.prefix = prefix if prefix is not None else config["modality"]
        Estimator.__init__(self, data_description, output_dir=output_dir,
                           **standard_config)

    def _variable_specs(self):
        cfg = self.config
        return progressive_fcn_variable_specs(
            self.prefix, self._input_channels(cfg["modality"]),
            {p: self._input_channels(m)
             for p, m in cfg["lateral_columns"].items()},
            cfg["num_units"], cfg["num_classes"],
            batchnorm=cfg["batch_normalization"],
            adapter_params=cfg["adapter"])

    def _score(self, ctx, batch):
        cfg = self.config
        return progressive_fcn(
            ctx, batch, self.prefix, cfg["modality"], cfg["lateral_columns"],
            cfg["num_units"], cfg["num_classes"],
            batchnorm=cfg["batch_normalization"],
            adapter_params=cfg["adapter"])["score"]

    def _train_outputs(self, ctx, batch):
        log_prob = ll.log_softmax(self._score(ctx, batch))
        return {"loss": cross_entropy(log_prob, batch["labels"],
                                      axis_name=ctx.sharded_axes)}

    def _test_outputs(self, ctx, batch):
        prob = ll.softmax(self._score(ctx, batch))
        return {"prob": prob,
                "prediction": prob.argmax(-1).to(torch.int32)}
