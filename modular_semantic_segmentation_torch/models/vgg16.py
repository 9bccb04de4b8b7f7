"""The bare VGG16 conv stack and its progressive-networks column
(counterpart of the JAX package's ``models/vgg16.py``).

Layer names are ``{prefix}_convX_Y`` at the top level (the flat naming of
the reference's second npz convention), unlike SimpleFCN's
``{prefix}/convX_Y``. The variable specs give what trains: the caller's
``trainable`` for the plain stack, everything for the progressive column
(its adapters' scales and convs included).
"""

from modular_semantic_segmentation_torch.ops import init as initializers
from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.init import layer_specs

# (layer, output width); a width of None is a 2x2 max pool
LAYERS = (("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
          ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
          ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
          ("pool3", None),
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
          ("pool4", None),
          ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512))
# the progressive column's adapter blocks: layer -> the lateral columns'
# layer that feeds it
ADAPTED = {"conv1_2": "conv1_1", "conv2_2": "conv2_1", "conv3_3": "conv3_2",
           "conv4_3": "conv4_2", "conv5_3": "conv5_2"}


def _stack(ctx, x, conv):
    """The layer dict of VGG16 over ``x``, each conv ``conv(x, width,
    layer)``."""
    l = {}
    for name, width in LAYERS:
        x = l[name] = (ll.max_pool2d(ctx, x, 2, 2) if width is None
                       else conv(x, width, name))
    return l


def vgg16(ctx, inputs, prefix, params):
    """VGG16 image encoder returning all intermediate layers; ``params``
    are ``conv2d``'s keyword arguments (``batch_normalization``)."""
    return _stack(ctx, inputs, lambda x, width, name: ll.conv2d(
        ctx, x, width, 3, f"{prefix}_{name}", **params))


def progressive_vgg16(ctx, inputs, columns, prefix, params,
                      adapter_params):
    """VGG16 as a progressive-networks column (arXiv 1606.04671): the
    layers of ``ADAPTED`` are adapter blocks (``layers.adap_conv``) fed
    the previous layer of each earlier, frozen column.

    Args:
        columns: {layer name: [outputs of the earlier columns]}.
        params: ``conv2d``'s keyword arguments.
        adapter_params: the adapter config; ``extra_convolution`` (default
            True) acts here, the rest are initial values in the specs.
    """
    extra = adapter_params.get("extra_convolution", True)

    def conv(x, width, name):
        if name in ADAPTED:
            return ll.adap_conv(ctx, x, columns[ADAPTED[name]], width, 3,
                                name=f"{prefix}_{name}",
                                extra_convolution=extra, **params)
        return ll.conv2d(ctx, x, width, 3, f"{prefix}_{name}", **params)
    return _stack(ctx, inputs, conv)


def vgg16_variable_specs(prefix, in_channels, batchnorm=False,
                         trainable=True):
    """Specs of the variables :func:`vgg16` reads; ``trainable`` applies
    to the kernels and biases."""
    specs, width = [], in_channels
    for name, out in LAYERS:
        if out is not None:
            specs += layer_specs(f"{prefix}_{name}", (3, 3, width, out), out,
                                 batchnorm, trainable)
            width = out
    return specs


def progressive_vgg16_variable_specs(prefix, in_channels, num_columns,
                                     batchnorm=False, extra_convolution=True,
                                     initial_scales=(1, 0.1),
                                     initialize_half_zero=False):
    """Specs of the variables :func:`progressive_vgg16` reads, all
    trainable, with ``num_columns`` lateral columns: an adapter block's
    ``adapter/scale`` starts at one pick of ``initial_scales``; its
    combination kernel from ``half_zeros`` when ``initialize_half_zero``."""
    specs, width = [], in_channels
    combination_init = (initializers.half_zeros() if initialize_half_zero
                        else initializers.glorot_uniform)
    for name, out in LAYERS:
        if out is None:
            continue
        scope = f"{prefix}_{name}"
        if name not in ADAPTED:
            specs += layer_specs(scope, (3, 3, width, out), out, batchnorm)
            width = out
            continue
        lateral = num_columns * width
        specs.append((f"{scope}/adapter/scale", (num_columns,),
                      initializers.selection(list(initial_scales)), True))
        if extra_convolution:
            specs += layer_specs(f"{scope}/adapter/adapter",
                                 (1, 1, lateral, width), width, False)
            lateral = width
        specs += layer_specs(f"{scope}/combination",
                             (3, 3, width + lateral, out), out, batchnorm,
                             kernel_init=combination_init)
        width = out
    return specs
