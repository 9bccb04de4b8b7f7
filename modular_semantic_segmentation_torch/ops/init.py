"""Initializers, as seeded numpy, and a variable store built from specs.

Mirrors the JAX package's ``ops/init.py``: Glorot-uniform conv kernels,
zero biases, BN ones/zeros, the frozen bilinear-interpolation kernel of
the transposed convolutions, the random pick ``selection`` (the adapters'
scales) and the progressive nets' ``half_zeros``. The random numbers come
from a numpy ``RandomState``, so full-width weights are made from a seed
without any file (they differ from the JAX package's ``jax.random`` draws; tests carry
JAX weights across with ``models.params.from_jax_variables``).

An initializer is ``fn(rng, shape) -> np.ndarray`` (float32).
"""

import numpy as np
import torch


def zeros(rng, shape):
    return np.zeros(shape, np.float32)


def ones(rng, shape):
    return np.ones(shape, np.float32)


def glorot_uniform(rng, shape):
    """TF glorot/xavier uniform: limit = sqrt(6 / (fan_in + fan_out)).

    For conv kernels [H, W, in, out]: fan_in = H*W*in, fan_out = H*W*out.
    """
    if len(shape) >= 2:
        receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        fan_in = receptive * shape[-2]
        fan_out = receptive * shape[-1]
    else:
        fan_in = fan_out = int(np.prod(shape))
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def bilinear_filter(shape):
    """Frozen bilinear-interpolation kernel for transposed convolution.

    ``shape`` is [height, width, out_channels, in_channels] (TF
    conv2d_transpose layout, the npz contract). The kernel is diagonal
    over channels: channel i upsamples channel i.
    """
    height, width = shape[0], shape[1]
    factor = np.ceil(width / 2.0)
    center = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    bilinear = ((1 - np.abs(yy / factor - center)) *
                (1 - np.abs(xx / factor - center)))
    weights = np.zeros(shape, np.float32)
    diag = min(shape[2], shape[3])
    for i in range(diag):
        weights[:, :, i, i] = bilinear
    return weights


def bilinear_filter_initializer(rng, shape):
    return bilinear_filter(shape)


def build_variables(specs, seed=0, device="cpu"):
    """Make a variable store from ``[(name, shape, initializer[,
    trainable]), ...]``.

    Initializers draw from one ``np.random.RandomState(seed)`` in the order
    of ``specs``, so a seed and a spec list fix every weight. Returns a
    dict name -> float32 tensor on ``device``.
    """
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(init(rng, tuple(shape))).to(device)
            for name, shape, init, *_ in specs}


def layer_specs(scope, kernel_shape, out_ch, batchnorm, trainable=True,
                bias=True, kernel_init=glorot_uniform):
    """Specs of one conv or deconv, as the JAX package's layers create its
    variables: the kernel and bias (``bias``) train when ``trainable``;
    BN's gamma and beta always train and its moving statistics never
    do."""
    specs = [(f"{scope}/kernel", kernel_shape, kernel_init, trainable)]
    if bias:
        specs.append((f"{scope}/bias", (out_ch,), zeros, trainable))
    if batchnorm:
        specs += [(f"{scope}/gamma", (out_ch,), ones, True),
                  (f"{scope}/beta", (out_ch,), zeros, True),
                  (f"{scope}/moving_mean", (out_ch,), zeros, False),
                  (f"{scope}/moving_variance", (out_ch,), ones, False)]
    return specs


def trainable_map(specs):
    """``{name: bool}`` from ``[(name, shape, initializer, trainable),
    ...]``: which variables the optimizer updates (the JAX package's
    ``net.trainable``)."""
    return {name: bool(trainable) for name, _, _, trainable in specs}


def selection(values):
    """Initialize to a random pick from ``values`` (a scalar pick fills
    the whole requested shape), as the JAX package's ``selection``; the
    pick comes from the port's rng, so it matches JAX's in distribution
    only."""
    def _init(rng, shape):
        pick = values[rng.randint(len(values))]
        return np.broadcast_to(np.asarray(pick, np.float32),
                               shape).copy()
    return _init


def half_zeros(only_dampened=True):
    """The progressive nets' combination-kernel initializer, as the JAX
    package's ``half_zeros``: the first half of the input channels is
    0.1 * Glorot-uniform (zero unless ``only_dampened``), the second half
    the identity at the kernel's centre when dim_in == 2 * dim_out, else
    Glorot-uniform."""
    def _init(rng, shape):
        kh, kw, dim_in, dim_out = shape
        if dim_in % 2:
            raise ValueError(f"half_zeros needs an even input dimension, "
                             f"got {dim_in}")
        half = (kh, kw, dim_in // 2, dim_out)
        first = (0.1 * glorot_uniform(rng, half) if only_dampened
                 else np.zeros(half, np.float32))
        if dim_in == 2 * dim_out:
            second = np.zeros(half, np.float32)
            second[kh // 2, kw // 2] = np.eye(dim_out)
        else:
            second = glorot_uniform(rng, half)
        return np.concatenate([first, second], axis=2).astype(np.float32)
    return _init
