"""The fusion experts' stems on the int8 serving path (counterpart of the
JAX package's ``models/packed_experts.py``).

The JAX package runs the conv1_1..conv2_1 stems of all FCN experts as one
block-diagonal conv stack, E times as wide,

    [ W_rgb   0      ]
    [ 0     W_depth  ]

a measure of lane occupancy on the TPU's matrix unit. In int8 it
quantizes each expert's input channels with that expert's own activation
scale and dequantizes each output channel with (its expert's scale x its
per-channel kernel scale). That is exactly per-expert int8 arithmetic:
the block-diagonal kernel sends expert e's input block only to expert e's
output block, its per-output-channel kernel scale equals the expert's own
(the zero blocks never raise a max), and the zero products add exact
zeros to the int32 sums.

So the port runs each expert's stem on its own, with the same results:
conv1_2 and conv2_1 take the int8 path with the scales that
``models/quantize.select_scales`` emitted under ``packed:`` keys for the
packed width, each expert with its own, when every expert has its key;
otherwise they stay float. conv1_1 stays float, as it does in the JAX
package's packed stack. No stem conv reads an unpacked
``<scope>/input_amax`` key here. Whether a dense block-diagonal stem pays
on the H100 is a question for a measurement (ROADMAP.md).
"""

from modular_semantic_segmentation_torch.models.quantize import \
    PACKED_STEM_CONVS
from modular_semantic_segmentation_torch.models.simple_fcn import \
    encoder_stem


def can_pack_stems(ctx, batch, modalities, config):
    """True when the packed stem applies: ``pack_experts`` (default on),
    FCN experts, at least two modalities, not a calibration pass (whose
    amax keys are the unpacked scopes) nor a height-sharded one (whose
    convs stay float), one spatial grid, and inputs of at most 4
    channels."""
    if not config.get("pack_experts", True):
        return False
    if ctx.spatial_axis is not None:
        return False
    if config.get("expert_model") != "fcn":
        return False
    if len(modalities) < 2:
        return False
    if ctx.calibrate:
        return False
    shapes = {tuple(int(s) for s in batch[m].shape[:3]) for m in modalities}
    if len(shapes) != 1:
        return False
    if any(int(batch[m].shape[-1]) > 4 for m in modalities):
        return False
    return True


def packed_fcn_stems(ctx, batch, modalities, prefixes, channel_factor=1.0,
                     batch_normalization=False):
    """All experts' conv1_1..conv2_1 stems, under the packed stem's int8
    scales. Returns ``{modality: {conv1_1, conv1_2, pool1, conv2_1}}``,
    for ``simple_fcn.encoder_head``'s ``stem_layers=``."""
    scales = {}
    for name in PACKED_STEM_CONVS:
        keys = {f"{prefixes[m]}/{name}/input_amax":
                f"packed:{prefixes[m]}/{name}/input_amax"
                for m in modalities}
        if ctx.act_scales and all(k in ctx.act_scales
                                  for k in keys.values()):
            scales.update({key: ctx.act_scales[packed]
                           for key, packed in keys.items()})
    with ctx.serving_scales(scales):
        return {m: encoder_stem(ctx, batch[m], prefixes[m],
                                batchnorm=batch_normalization,
                                channel_factor=channel_factor)
                for m in modalities}
