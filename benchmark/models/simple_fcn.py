"""The SimpleFCN family: the VGG16 FCN expert and its Bayes fusion.

What the benchmark needs of it: the variables under the program's names
(``variable_specs``), the FLOPs the algorithm needs (``expert_flops``,
``fused_frame_flops``), the calls of the frozen upsampling
(``upsample_calls``), the program's models (``build_fusion``,
``build_trainer``) and the reference's class scores (``reference_scores``).
"""

from benchmark.reference import vgg_fcn

VGG16_CONVS = (("conv1_1", None, 64, 1), ("conv1_2", 64, 64, 1),
               ("conv2_1", 64, 128, 2), ("conv2_2", 128, 128, 2),
               ("conv3_1", 128, 256, 4), ("conv3_2", 256, 256, 4),
               ("conv3_3", 256, 256, 4), ("conv4_1", 256, 512, 8),
               ("conv4_2", 512, 512, 8), ("conv4_3", 512, 512, 8),
               ("conv5_1", 512, 512, 16), ("conv5_2", 512, 512, 16),
               ("conv5_3", 512, 512, 16))


def _layer(scope, shape, kind, batchnorm, bias=True):
    """Specs of one conv or transposed conv: (name, shape, kind)."""
    out = shape[-1] if kind == "kernel" else shape[2]
    specs = [(f"{scope}/kernel", shape, kind)]
    if bias:
        specs.append((f"{scope}/bias", (out,), "bias"))
    if batchnorm:
        specs += [(f"{scope}/gamma", (out,), "gamma"),
                  (f"{scope}/beta", (out,), "beta"),
                  (f"{scope}/moving_mean", (out,), "moving_mean"),
                  (f"{scope}/moving_variance", (out,), "moving_variance")]
    return specs


def variable_specs(config, prefix, in_channels, batchnorm):
    """[(name, shape, kind)] of one expert; kinds are those of
    ``harness/weights.py``."""
    units, classes = config["num_units"], config["num_classes"]
    specs = []
    for name, cin, cout, _ in VGG16_CONVS:
        specs += _layer(f"{prefix}/{name}", (3, 3, cin or in_channels, cout),
                        "kernel", batchnorm)
    for name in ("score_conv4", "score_conv5"):
        specs += _layer(f"{prefix}/{name}", (1, 1, 512, units), "kernel",
                        batchnorm)
    specs += _layer(f"{prefix}/upscore_conv5", (4, 4, units, units),
                    "bilinear", batchnorm, bias=False)
    specs += _layer(f"{prefix}/upscore", (16, 16, units, units), "bilinear",
                    batchnorm, bias=False)
    specs += _layer(f"{prefix}/score", (1, 1, units, classes), "kernel",
                    batchnorm)
    return specs


def encoder_flops(height, width, in_channels):
    """FLOPs (2 per multiply-add) of the thirteen VGG16 convolutions."""
    return sum(2 * 9 * (cin or in_channels) * cout * (height // s)
               * (width // s) for _, cin, cout, s in VGG16_CONVS)


def expert_flops(config, height, width, in_channels):
    """FLOPs of one expert's forward pass: the encoder, the two 1x1 score
    convolutions, the two bilinear upsamplings as the depthwise transposed
    convolutions that they are (k * k multiply-adds per input pixel and
    channel), and the 1x1 class scores."""
    units, classes = config["num_units"], config["num_classes"]
    p8 = (height // 8) * (width // 8)
    p16 = (height // 16) * (width // 16)
    return (encoder_flops(height, width, in_channels)
            + 2 * 512 * units * (p8 + p16)
            + 2 * 16 * units * p16 + 2 * 256 * units * p8
            + 2 * units * classes * height * width)


def fused_frame_flops(config):
    """FLOPs of one fused frame: every expert, and the fusion's sum of one
    table row per expert for each class at each pixel."""
    serve = config["serve"]
    h, w = serve["height"], serve["width"]
    experts = sum(expert_flops(config, h, w, ch)
                  for ch in config["modalities"].values())
    return experts + len(config["modalities"]) * config["num_classes"] * h * w


def train_image_flops(config):
    """Forward FLOPs of one training image; a training step costs about
    three times that (forward, and the two products of the backward)."""
    train = config["train"]
    return expert_flops(config, train["height"], train["width"],
                        config["modalities"][train["modality"]])


def upsample_calls(config):
    """The frozen bilinear upsamplings of one expert at the served size:
    (input height, input width, channels, kernel, stride)."""
    serve = config["serve"]
    h, w, units = serve["height"], serve["width"], config["num_units"]
    return [(h // 16, w // 16, units, 4, 2), (h // 8, w // 8, units, 16, 8)]


def _description(config, modalities):
    import numpy as np
    return ({"labels": np.int32, **{m: np.float32 for m in modalities}},
            {"labels": (None, None),
             **{m: (None, None, config["modalities"][m]) for m in modalities}},
            config["num_classes"])


def build_fusion(config, confusion_matrices, device, seed):
    """The program's Bayes fusion of the configuration's experts, served
    as the configuration states."""
    from modular_semantic_segmentation_torch.models import get_model
    serve = config["serve"]
    modalities = list(config["modalities"])
    return get_model(config["fusion"])(
        data_description=_description(config, modalities),
        confusion_matrices=confusion_matrices,
        num_units=config["num_units"], expert_model=config["expert_model"],
        prefixes={m: m for m in modalities}, batchsize=serve["batch"],
        compute_dtype=serve["dtype"],
        batch_normalization=serve["batch_normalization"], seed=seed,
        device=device)


def build_trainer(config, device, seed):
    """The program's expert for ``Estimator.fit``, configured as the
    configuration trains it."""
    from modular_semantic_segmentation_torch.models import get_model
    train = config["train"]
    modality = train["modality"]
    return get_model("simple_fcn")(
        prefix=modality, modality=modality,
        data_description=_description(config, [modality]),
        num_units=config["num_units"],
        batch_normalization=train["batch_normalization"],
        trainer=train["trainer"], learning_rate=train["learning_rate"],
        batchsize=train["batch"], compute_dtype=train["dtype"], seed=seed,
        device=device)


def reference_scores(weights, prefix, x, batchnorm, train=False):
    """(class scores NCHW, layers) of the plain reference for NCHW ``x``."""
    return vgg_fcn.forward(weights, prefix, x, batchnorm, train=train)


def trainable(specs):
    """Names the optimizer updates: every kernel and bias but the frozen
    bilinear kernels, and batch norm's scale and offset."""
    return [name for name, _, kind in specs
            if kind in ("kernel", "bias", "gamma", "beta")]
