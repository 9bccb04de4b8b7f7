"""Seeded weights and confusion matrices, made by the benchmark and handed
to the program and to the reference alike.

Weights are made on the device from a ``torch.Generator``, one normal draw
for all variables together, in float32 (the program's variable store is
float32; the served dtype is a cast inside its layers). By kind:

    kernel            He normal: std sqrt(2 / (kh * kw * in))
    deconv            He normal over the taps that reach an output pixel:
                      std sqrt(2 / ((kh / stride)^2 * in)), the stride
                      taken as kh / 2 for 4x4 and kh / 8 for 16x16
    bilinear          the frozen bilinear kernel (no draw)
    bias, beta,
    moving_mean       0.1 * normal
    gamma             1 + 0.1 * normal
    moving_variance   1 + 0.25 * |normal|
"""

import math

import numpy as np
import torch

from benchmark.reference.bayes import decision_margin
from benchmark.reference.layers import bilinear_kernel

_STRIDE_OF_KERNEL = {4: 2, 16: 8}


def _std(shape, kind):
    if kind == "kernel":
        kh, kw, cin, _ = shape
        return math.sqrt(2.0 / (kh * kw * cin))
    if kind == "deconv":
        kh, kw, _, cin = shape
        reach = (kh / _STRIDE_OF_KERNEL.get(kh, 1)) ** 2
        return math.sqrt(2.0 / (reach * cin))
    return 0.1


def make_weights(specs, seed, device):
    """``{name: float32 tensor on device}`` for ``specs`` [(name, shape,
    kind)], from ``seed``; the same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    drawn = [(name, shape, kind) for name, shape, kind in specs
             if kind != "bilinear"]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    noise = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "bilinear":
            out[name] = torch.from_numpy(
                bilinear_kernel(shape[0], shape[2])).to(device)
            continue
        n = math.prod(shape)
        value = noise[at:at + n].view(shape)
        at += n
        if kind == "gamma":
            value = 1.0 + 0.1 * value
        elif kind == "moving_variance":
            value = 1.0 + 0.25 * value.abs()
        else:
            value = value * _std(shape, kind)
        out[name] = value
    return out


def make_confusion_matrices(modalities, num_classes, seed, min_margin=1e-3):
    """``{modality: [K, K] float64}``: uniform(0, 1) plus 5 on the
    diagonal, redrawn from the same stream until the fused decision has no
    tie closer than ``min_margin``, so a float32 fusion and the float64
    reference decide alike."""
    rng = np.random.RandomState(seed)
    while True:
        mats = {m: rng.rand(num_classes, num_classes)
                + 5 * np.eye(num_classes) for m in modalities}
        if decision_margin(list(mats.values())) > min_margin:
            return mats
