"""SimpleFCN: the VGG16-based fully-convolutional segmentation expert.

Counterpart of the JAX package's ``models/simple_fcn.py``: VGG16 conv
stack, 1x1 score convs on conv4_3 and conv5_3, frozen 4x4/stride-2
bilinear deconv on score_conv5, added into 'fused'; decoder = frozen
16x16/stride-8 bilinear deconv + 1x1 class score conv. The reference's
MC-dropout sites (after pool3 and pool4, before the two score convs, and
on the decoder's features) are there for the MC-dropout models; every
one of them lies after pool3, so :func:`encoder_head` is deterministic.

``encoder``/``decoder``/``fcn`` are plain functions returning layer dicts,
so fusion models build experts without expert model objects.
``fcn_variable_specs`` lists the variables those functions read, under the
same TF names and with the JAX package's trainable flags, so a store can
be made up front from a seed.
"""

import torch

from modular_semantic_segmentation_torch.ops import init as initializers
from modular_semantic_segmentation_torch.ops.init import layer_specs
from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.models.estimator import Estimator


def _width(channel_factor):
    return lambda w: max(1, int(w * channel_factor))


def encoder_stem(ctx, inputs, prefix, batchnorm=True, channel_factor=1.0):
    """conv1_1 .. conv2_1, the full/half-resolution thin-channel stem."""
    params = {"batch_normalization": batchnorm}
    c = _width(channel_factor)
    with ctx.scope(prefix):
        l = {}
        l["conv1_1"] = ll.conv2d(ctx, inputs, c(64), 3, "conv1_1", **params)
        l["conv1_2"] = ll.conv2d(ctx, l["conv1_1"], c(64), 3, "conv1_2",
                                 **params)
        l["pool1"] = ll.max_pool2d(ctx, l["conv1_2"], 2, 2)
        l["conv2_1"] = ll.conv2d(ctx, l["pool1"], c(128), 3, "conv2_1",
                                 **params)
    return l


def encoder_head(ctx, inputs, prefix, batchnorm=True, channel_factor=1.0,
                 stem_layers=None):
    """conv1_1 .. pool3. ``channel_factor`` scales every VGG16 width
    (64..512); 1.0 is the reference architecture. ``stem_layers``: the
    conv1_1..conv2_1 layer dict when it was computed already (the fusion
    experts' packed stems, ``models/packed_experts.py``)."""
    params = {"batch_normalization": batchnorm}
    c = _width(channel_factor)
    l = (dict(stem_layers) if stem_layers is not None
         else encoder_stem(ctx, inputs, prefix, batchnorm=batchnorm,
                           channel_factor=channel_factor))
    with ctx.scope(prefix):
        l["conv2_2"] = ll.conv2d(ctx, l["conv2_1"], c(128), 3, "conv2_2",
                                 **params)
        l["pool2"] = ll.max_pool2d(ctx, l["conv2_2"], 2, 2)
        l["conv3_1"] = ll.conv2d(ctx, l["pool2"], c(256), 3, "conv3_1",
                                 **params)
        l["conv3_2"] = ll.conv2d(ctx, l["conv3_1"], c(256), 3, "conv3_2",
                                 **params)
        l["conv3_3"] = ll.conv2d(ctx, l["conv3_2"], c(256), 3, "conv3_3",
                                 **params)
        l["pool3"] = ll.max_pool2d(ctx, l["conv3_3"], 2, 2)
    return l


def encoder_tail(ctx, l, prefix, num_units, batchnorm=True,
                 channel_factor=1.0, dropout_rate=0.0, dropout_layers=()):
    """pool3 .. 'fused', with the reference's MC-dropout sites. ``l`` is
    the layer dict from :func:`encoder_head`; mutates and returns it.

    ``dropout_layers`` names the sites that drop at ``dropout_rate``:
    'pool3' (after pool3 and, a quirk of the reference kept as in the
    JAX package, after pool4 too), and 'conv4_3' / 'conv5_3' (before
    their score convs). Dropout always draws here, as the reference's
    MC-dropout runs with training=True at test time."""
    params = {"batch_normalization": batchnorm}
    c = _width(channel_factor)
    with ctx.scope(prefix):
        last_layer = l["pool3"]
        if "pool3" in dropout_layers:
            l["pool3_drop"] = ll.dropout(ctx, l["pool3"], dropout_rate)
            last_layer = l["pool3_drop"]
        l["conv4_1"] = ll.conv2d(ctx, last_layer, c(512), 3, "conv4_1",
                                 **params)
        l["conv4_2"] = ll.conv2d(ctx, l["conv4_1"], c(512), 3, "conv4_2",
                                 **params)
        l["conv4_3"] = ll.conv2d(ctx, l["conv4_2"], c(512), 3, "conv4_3",
                                 **params)
        l["pool4"] = ll.max_pool2d(ctx, l["conv4_3"], 2, 2)
        last_layer = l["pool4"]
        # the reference gates pool4's dropout on 'pool3' as well
        if "pool3" in dropout_layers:
            l["pool4_drop"] = ll.dropout(ctx, l["pool4"], dropout_rate)
            last_layer = l["pool4_drop"]
        l["conv5_1"] = ll.conv2d(ctx, last_layer, c(512), 3, "conv5_1",
                                 **params)
        l["conv5_2"] = ll.conv2d(ctx, l["conv5_1"], c(512), 3, "conv5_2",
                                 **params)
        l["conv5_3"] = ll.conv2d(ctx, l["conv5_2"], c(512), 3, "conv5_3",
                                 **params)
        conv4_3 = l["conv4_3"]
        if "conv4_3" in dropout_layers:
            conv4_3 = ll.dropout(ctx, conv4_3, dropout_rate)
        score_conv4 = ll.conv2d(ctx, conv4_3, num_units, 1, "score_conv4",
                                **params)
        conv5_3 = l["conv5_3"]
        if "conv5_3" in dropout_layers:
            conv5_3 = ll.dropout(ctx, conv5_3, dropout_rate)
        score_conv5 = ll.conv2d(ctx, conv5_3, num_units, 1, "score_conv5",
                                **params)
        upscore_conv5 = ll.deconv2d(ctx, score_conv5, num_units, 4,
                                    "upscore_conv5", strides=2,
                                    activation=torch.relu,
                                    batch_normalization=batchnorm)
        l["fused"] = score_conv4 + upscore_conv5
    return l


def encoder(ctx, inputs, prefix, num_units, batchnorm=True,
            channel_factor=1.0, dropout_rate=0.0, dropout_layers=(),
            stem_layers=None):
    """VGG16 image encoder; the encoding has key 'fused'."""
    l = encoder_head(ctx, inputs, prefix, batchnorm=batchnorm,
                     channel_factor=channel_factor, stem_layers=stem_layers)
    return encoder_tail(ctx, l, prefix, num_units, batchnorm=batchnorm,
                        channel_factor=channel_factor,
                        dropout_rate=dropout_rate,
                        dropout_layers=dropout_layers)


def decoder(ctx, features, prefix, num_units, num_classes, batchnorm=True,
            dropout_rate=None):
    """Frozen 16x16/stride-8 bilinear upsampling + 1x1 class score conv
    (no activation before the softmax); with a ``dropout_rate``, MC
    dropout on the features first."""
    with ctx.scope(prefix):
        if dropout_rate is not None:
            features = ll.dropout(ctx, features, dropout_rate)
        upscore = ll.deconv2d(ctx, features, num_units, 16, "upscore",
                              strides=8, activation=torch.relu,
                              batch_normalization=batchnorm)
        score = ll.conv2d(ctx, upscore, num_classes, 1, "score",
                          activation=None, batch_normalization=batchnorm)
    return {"upscore": upscore, "score": score}


def fcn(ctx, inputs, prefix, num_units, num_classes, batchnorm=True,
        channel_factor=1.0, dropout_rate=0.0, dropout_layers=(),
        stem_layers=None):
    """Full FCN: encoder + decoder; 'features' in ``dropout_layers`` drops
    the decoder's input too."""
    layers = encoder(ctx, inputs, prefix, num_units, batchnorm=batchnorm,
                     channel_factor=channel_factor,
                     dropout_rate=dropout_rate,
                     dropout_layers=dropout_layers, stem_layers=stem_layers)
    layers.update(decoder(
        ctx, layers["fused"], prefix, num_units, num_classes,
        batchnorm=batchnorm,
        dropout_rate=(dropout_rate if "features" in dropout_layers
                      else None)))
    return layers


def fcn_variable_specs(prefix, in_channels, num_units, num_classes,
                       batchnorm=True, channel_factor=1.0, trainable=True):
    """[(name, shape, initializer, trainable)] of every variable
    :func:`fcn` reads. ``trainable`` (config ``train_encoder``) applies
    to every conv's kernel and bias; the bilinear deconv kernels are
    frozen."""
    c = _width(channel_factor)
    convs = [("conv1_1", in_channels, c(64)), ("conv1_2", c(64), c(64)),
             ("conv2_1", c(64), c(128)), ("conv2_2", c(128), c(128)),
             ("conv3_1", c(128), c(256)), ("conv3_2", c(256), c(256)),
             ("conv3_3", c(256), c(256)), ("conv4_1", c(256), c(512)),
             ("conv4_2", c(512), c(512)), ("conv4_3", c(512), c(512)),
             ("conv5_1", c(512), c(512)), ("conv5_2", c(512), c(512)),
             ("conv5_3", c(512), c(512))]
    specs = []
    for name, cin, cout in convs:
        specs += layer_specs(f"{prefix}/{name}", (3, 3, cin, cout), cout,
                             batchnorm, trainable)
    for name in ("score_conv4", "score_conv5"):
        specs += layer_specs(f"{prefix}/{name}", (1, 1, c(512), num_units),
                             num_units, batchnorm, trainable)
    specs += bilinear_deconv_specs(f"{prefix}/upscore_conv5", 4, num_units,
                                   batchnorm)
    return specs + decoder_variable_specs(prefix, num_units, num_classes,
                                          batchnorm, trainable)


def bilinear_deconv_specs(scope, kernel, units, batchnorm):
    """Specs of a frozen square bilinear deconv without bias."""
    return layer_specs(scope, (kernel, kernel, units, units), units,
                       batchnorm, trainable=False, bias=False,
                       kernel_init=initializers.bilinear_filter_initializer)


def decoder_variable_specs(prefix, num_units, num_classes, batchnorm=True,
                           trainable=True):
    """Specs of the variables :func:`decoder` reads: the frozen 16x16/s8
    deconv and the class score conv (``trainable``)."""
    return (bilinear_deconv_specs(f"{prefix}/upscore", 16, num_units,
                                  batchnorm)
            + layer_specs(f"{prefix}/score", (1, 1, num_units, num_classes),
                          num_classes, batchnorm, trainable))


class SimpleFCN(Estimator):
    """FCN expert model.

    Args:
        prefix: variable-name prefix (the modality column name).
        data_description: tuple from dataset.get_data_description().
        modality: key of the input modality in data batches.
        num_units: feature units in the FCN.
        batch_normalization, channel_factor: see :func:`fcn`.
        train_encoder: whether the convs' kernels and biases train
            (default True); BN's gamma and beta train either way.
    """

    # int8 serving: no spatial floor for the VGG16 stack, as in the JAX
    # package (Estimator.ptq_min_pixels)
    ptq_min_pixels = 0

    def __init__(self, prefix, data_description, modality, output_dir=None,
                 **config):
        self.prefix = prefix
        self.modality = modality
        standard_config = {"train_encoder": True,
                           "batch_normalization": True}
        standard_config.update(config)
        Estimator.__init__(self, data_description, output_dir=output_dir,
                           **standard_config)

    def _variable_specs(self):
        return fcn_variable_specs(
            self.prefix, self._input_channels(self.modality),
            self.config["num_units"], self.config["num_classes"],
            batchnorm=self.config["batch_normalization"],
            channel_factor=self.config.get("channel_factor", 1.0),
            trainable=self.config["train_encoder"])

    def _fcn(self, ctx, x):
        return fcn(ctx, x, self.prefix, self.config["num_units"],
                   self.config["num_classes"],
                   batchnorm=self.config["batch_normalization"],
                   channel_factor=self.config.get("channel_factor", 1.0))

    def _train_outputs(self, ctx, batch):
        layers = self._fcn(ctx, batch[self.modality])
        log_prob = ll.log_softmax(layers["score"])
        return {"loss": cross_entropy(log_prob, batch["labels"],
                                      axis_name=ctx.sharded_axes)}

    def _test_outputs(self, ctx, batch):
        layers = self._fcn(ctx, batch[self.modality])
        prob = ll.softmax(layers["score"])
        return {"prob": prob,
                "prediction": prob.argmax(-1).to(torch.int32)}
