"""FusionFCN: the architecture-level (late-concat) fusion baseline, trained
end to end (counterpart of the JAX package's ``models/fusion_fcn.py``).

One VGG16 per modality, channel-concat of conv4_3's and conv5_3's across
modalities, fused 1x1 score convs, a frozen 4x4/s2 bilinear deconv, and
SimpleFCN's decoder, all without batch norm.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.init import layer_specs
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.models.estimator import Estimator
from modular_semantic_segmentation_torch.models.simple_fcn import (
    bilinear_deconv_specs, decoder, decoder_variable_specs)
from modular_semantic_segmentation_torch.models.vgg16 import (
    vgg16, vgg16_variable_specs)


def fusion_fcn(ctx, inputs, prefixes, num_units, num_classes):
    """The late-fusion FCN graph over ``inputs`` {modality: frames};
    ``prefixes`` {modality: prefix}. Returns the layer dict ('score')."""
    params = {"batch_normalization": False}
    layers = {}
    for modality, prefix in prefixes.items():
        layers[modality] = vgg16(ctx, inputs[modality], prefix, params)
    for k in (4, 5):
        layers[f"concat_conv{k}"] = torch.cat(
            [layers[m][f"conv{k}_3"] for m in prefixes], dim=-1)
        layers[f"score_conv{k}"] = ll.conv2d(
            ctx, layers[f"concat_conv{k}"], num_units, 1,
            f"fused_score_conv{k}", **params)
    layers["upscore_conv5"] = ll.deconv2d(
        ctx, layers["score_conv5"], num_units, 4, "fused_upscore_conv5",
        strides=2, activation=torch.relu, batch_normalization=False)
    layers["features"] = layers["score_conv4"] + layers["upscore_conv5"]
    layers.update(decoder(ctx, layers["features"], "fused", num_units,
                          num_classes, batchnorm=False))
    return layers


def fusion_fcn_variable_specs(prefixes, in_channels, num_units,
                              num_classes):
    """Specs of the variables :func:`fusion_fcn` reads; ``in_channels``
    {modality: channels}. Every conv trains; the two bilinear deconvs are
    frozen."""
    specs = []
    for modality, prefix in prefixes.items():
        specs += vgg16_variable_specs(prefix, in_channels[modality])
    for k in (4, 5):
        specs += layer_specs(f"fused_score_conv{k}",
                             (1, 1, 512 * len(prefixes), num_units),
                             num_units, False)
    return (specs
            + bilinear_deconv_specs("fused_upscore_conv5", 4, num_units,
                                    False)
            + decoder_variable_specs("fused", num_units, num_classes,
                                     batchnorm=False))


class FusionFCN(Estimator):
    """End-to-end trained late-fusion FCN.

    Config: prefixes {modality: prefix}, num_units; the default trainer is
    rmsprop at 1e-4, as the JAX package's."""

    # the VGG16 stack: no int8 spatial floor, as SimpleFCN
    ptq_min_pixels = 0

    def __init__(self, data_description, output_dir=None, **config):
        standard_config = {"trainer": "rmsprop", "learning_rate": 0.0001}
        standard_config.update(config)
        self.modalities = list(standard_config["prefixes"].keys())
        Estimator.__init__(self, data_description, output_dir=output_dir,
                           **standard_config)

    def _variable_specs(self):
        return fusion_fcn_variable_specs(
            self.config["prefixes"],
            {m: self._input_channels(m) for m in self.modalities},
            self.config["num_units"], self.config["num_classes"])

    def _score(self, ctx, batch):
        return fusion_fcn(ctx, {m: batch[m] for m in self.modalities},
                          self.config["prefixes"], self.config["num_units"],
                          self.config["num_classes"])["score"]

    def _train_outputs(self, ctx, batch):
        log_prob = ll.log_softmax(self._score(ctx, batch))
        return {"loss": cross_entropy(log_prob, batch["labels"],
                                      axis_name=ctx.sharded_axes)}

    def _test_outputs(self, ctx, batch):
        prob = ll.softmax(self._score(ctx, batch))
        return {"prob": prob,
                "prediction": prob.argmax(-1).to(torch.int32)}
