"""Host-side image augmentation without cv2 (the port's copy of the JAX
package's ``datasets/augmentation.py``).

``augmentate`` draws from Python's ``random`` and numpy's global generator
in the JAX package's order, so that the same seeds give the same blob, and
keeps its quirks: 'hflip' flips axis 0 and 'vflip' axis 1, each gated by
its probability and a further coin toss; scale and shear apply only when a
crop is scheduled.

Where the JAX package calls cv2, the port has its own code:

* resizes go to the native library (``native_backend.resize``), as the
  JAX package's do when its library is built: bilinear on uint8, nearest
  on the other modalities; the gamma LUT on uint8 likewise;
* ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine`` are
  :func:`rotation_matrix` and :func:`warp_affine`, which reproduce
  OpenCV 5's arithmetic: see :func:`warp_affine`.
"""

import math
import random

import numpy as np

from modular_semantic_segmentation_torch.datasets import native_backend
from modular_semantic_segmentation_torch.datasets.native_backend import (
    INTER_LINEAR, INTER_NEAREST)

#: columns of one vector block of OpenCV 5's warpAffine kernels on an AVX2
#: host: a row's columns up to the last whole block take the vector
#: kernel's coordinates, the rest the scalar tail's (see warp_affine)
CV2_WARP_BLOCK = 16
# OpenCV's fixed-point coordinate bits of its generic (remap) warp path
_AB_BITS = 10
# dtypes and channel counts that OpenCV 5's float warp kernels take
_FLOAT_WARP = {(np.dtype(np.uint8), 1), (np.dtype(np.uint8), 3),
               (np.dtype(np.uint8), 4), (np.dtype(np.uint16), 1),
               (np.dtype(np.float32), 1)}


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``, rounded once: the product of two float32
    is exact in float64, and the float64 sum is rounded to odd (Boldo and
    Melquiond), so that its rounding to float32 is the fused one."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def rotation_matrix(center, angle, scale):
    """``cv2.getRotationMatrix2D(center, angle, scale)``: 2x3 float64."""
    rad = math.radians(angle)  # angle * (pi / 180), as OpenCV scales it
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_affine(matrix):
    """The inverse of a 2x3 affine map, in float64, as warpAffine
    inverts it."""
    m = np.asarray(matrix, np.float64).reshape(-1)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, m[1] * -d, m[3] * -d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _float_coords(inv, width, height):
    """Source coordinates (x, y), float32 [height, width], of OpenCV 5's
    float warp kernels: ``fma(M0, x, y*M1 + M2)`` in the vector blocks,
    ``fma(M0, x, y*M1) + M2`` in a row's scalar tail."""
    m = inv.astype(np.float32)
    x = np.arange(width, dtype=np.float32)[None, :]
    y = np.arange(height, dtype=np.float32)[:, None]
    block = (width // CV2_WARP_BLOCK) * CV2_WARP_BLOCK
    out = []
    for r in (0, 1):
        row = y * m[r, 1]
        head = _fma32(m[r, 0], x[:, :block], row + m[r, 2])
        tail = _fma32(m[r, 0], x[:, block:], row) + m[r, 2]
        out.append(np.concatenate([head, tail], axis=1))
    return out


def _gather(image, ys, xs):
    """image[ys, xs] with 0 outside the image (cv2's constant border)."""
    h, w = image.shape[:2]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    values = image[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    return np.where(inside[..., None], values, np.zeros((), image.dtype))


def warp_affine(image, matrix, dsize, flags=INTER_LINEAR):
    """``cv2.warpAffine(image, matrix, dsize, flags=flags)`` with its
    default zero border, as OpenCV 5.0 computes it on an AVX2 host.

    OpenCV 5 warps uint8 (1, 3 or 4 channels), uint16 and float32 (1
    channel) in float32: source coordinates from the inverse map in
    float32 (:func:`_float_coords`), then, for INTER_LINEAR, the fused
    ``fma(ax, p01 - p00, p00)`` along x and along y of the four
    neighbours, each outside neighbour 0, rounded half to even and
    saturated; for INTER_NEAREST the neighbour at the coordinates rounded
    half to even. Other dtypes take OpenCV's generic path: nearest
    rounds 10-bit fixed-point coordinates (this covers int32 labels), and
    INTER_LINEAR of int32 raises as cv2 raises. The older fixed-point
    bilinear path (1/32 pixel, 15-bit weights) is no longer what cv2
    computes for these dtypes.

    As cv2 does, a [H, W, 1] image comes back [H, W].
    """
    width, height = int(dsize[0]), int(dsize[1])
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    channels = image.shape[2] if image.ndim == 3 else 1
    img = image if image.ndim == 3 else image[..., None]
    inv = _inverse_affine(matrix)
    if (image.dtype, channels) in _FLOAT_WARP:
        sx, sy = _float_coords(inv, width, height)
        if flags == INTER_NEAREST:
            out = _gather(img, np.rint(sy).astype(np.int64),
                          np.rint(sx).astype(np.int64))
        elif flags == INTER_LINEAR:
            x0 = np.floor(sx).astype(np.int64)
            y0 = np.floor(sy).astype(np.int64)
            ax = (sx - x0.astype(np.float32))[..., None]
            ay = (sy - y0.astype(np.float32))[..., None]
            p00, p01, p10, p11 = (
                _gather(img, y0 + dy, x0 + dx).astype(np.float32)
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
            top = _fma32(ax, p01 - p00, p00)
            bottom = _fma32(ax, p11 - p10, p10)
            value = _fma32(ay, bottom - top, top)
            if image.dtype == np.float32:
                out = value
            else:
                info = np.iinfo(image.dtype)
                out = np.clip(np.rint(value), info.min, info.max).astype(
                    image.dtype)
        else:
            raise ValueError(f"unknown interpolation {flags}")
    elif flags == INTER_NEAREST and image.dtype.kind in "iuf":
        scale = 1 << _AB_BITS
        x = np.arange(width, dtype=np.float64)
        y = np.arange(height, dtype=np.float64)
        xs = ((np.rint((inv[0, 1] * y + inv[0, 2]) * scale).astype(np.int64)
               + scale // 2)[:, None]
              + np.rint(inv[0, 0] * x * scale).astype(np.int64)[None, :])
        ys = ((np.rint((inv[1, 1] * y + inv[1, 2]) * scale).astype(np.int64)
               + scale // 2)[:, None]
              + np.rint(inv[1, 0] * x * scale).astype(np.int64)[None, :])
        out = _gather(img, ys >> _AB_BITS, xs >> _AB_BITS)
    else:
        raise ValueError(
            f"warp_affine of {image.dtype} images with {channels} channels "
            f"and interpolation {flags} is not supported (cv2's float "
            f"kernels take {sorted((d.name, c) for d, c in _FLOAT_WARP)}; "
            "cv2 refuses bilinear warps of int32)")
    return out if image.ndim == 3 else out[..., 0]


def rotate_image(image, angle):
    """Rotate about the centre by ``angle`` degrees, into an output large
    enough to hold the whole rotated image."""
    h, w = image.shape[:2]
    center = (w / 2, h / 2)
    rot = rotation_matrix(center, angle, 1.0)
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    new_w = int(h * sin + w * cos)
    new_h = int(h * cos + w * sin)
    rot[0, 2] += new_w / 2 - center[0]
    rot[1, 2] += new_h / 2 - center[1]
    return warp_affine(image, rot, (new_w, new_h), flags=INTER_LINEAR)


def largest_rotated_rect(w, h, angle):
    """Width and height of the largest axis-aligned rectangle inside a
    w x h rectangle rotated by ``angle`` radians."""
    if w <= 0 or h <= 0:
        return 0, 0
    angle = abs(angle) % math.pi
    if angle > math.pi / 2:
        angle = math.pi - angle
    sin_a, cos_a = math.sin(angle), math.cos(angle)
    if sin_a == 0:
        return w, h
    side_long, side_short = max(w, h), min(w, h)
    if side_short <= 2.0 * sin_a * cos_a * side_long:
        x = 0.5 * side_short
        wr, hr = (x / sin_a, x / cos_a) if w >= h else (x / cos_a, x / sin_a)
    else:
        cos_2a = cos_a * cos_a - sin_a * sin_a
        wr = (w * cos_a - h * sin_a) / cos_2a
        hr = (h * cos_a - w * sin_a) / cos_2a
    return wr, hr


def crop_around_center(image, width, height):
    """Center crop to the given width and height."""
    h, w = image.shape[:2]
    width, height = min(int(width), w), min(int(height), h)
    x1 = int(w / 2 - width / 2)
    y1 = int(h / 2 - height / 2)
    return image[y1:y1 + height, x1:x1 + width]


def flip_labels(labels, c1, c2, prob=0.5):
    """Randomly map c1 onto c2 or the other way (label-ambiguity noise)."""
    if np.random.rand() < prob:
        labels[labels == c1] = c2
    else:
        labels[labels == c2] = c1
    return labels


def augmentate(blob, scale=False, crop=False, hflip=False, vflip=False,
               gamma=False, contrast=False, brightness=False, rotate=False,
               shear=False, label_flip=False, label_merge=False):
    """Probability-gated augmentations of an image blob, in place.

    Each argument leads with its probability, e.g. ``crop=(p, size)``,
    ``contrast=(p, low, high)``; ``hflip`` and ``vflip`` are the
    probability alone.
    """
    modalities = list(blob.keys())

    do_crop = bool(crop) and crop[0] > random.random()

    if scale and do_crop and scale[0] > random.random():
        h, w = blob[modalities[0]].shape[:2]
        min_scale = crop[1] / float(min(h, w))
        k = random.uniform(max(min_scale, scale[1]), scale[2])
        if "rgb" in blob:
            blob["rgb"] = native_backend.resize(blob["rgb"], k, k,
                                                INTER_LINEAR)
        for m in (m for m in modalities if m != "rgb"):
            blob[m] = native_backend.resize(blob[m], k, k, INTER_NEAREST)

    if rotate and rotate[0] > random.random():
        h, w = blob[modalities[0]].shape[:2]
        deg = np.random.randint(rotate[1], rotate[2])
        rect = largest_rotated_rect(w, h, math.radians(deg))
        for m in modalities:
            blob[m] = crop_around_center(rotate_image(blob[m], deg), *rect)

    if shear and do_crop and shear[0] > random.random():
        h, w = blob[modalities[0]].shape[:2]
        shear_px = np.random.randint(int(shear[1] * w), int(shear[2] * w)) \
            * np.random.choice([-1, 1])
        mat = np.float32([[1, shear_px / h, 0], [0, 1, 0]])
        for m in modalities:
            interp = INTER_LINEAR if m == "rgb" else INTER_NEAREST
            blob[m] = warp_affine(blob[m], mat, (w, h), flags=interp)

    if do_crop:
        h, w = blob[modalities[0]].shape[:2]
        h_c = random.randint(0, h - crop[1])
        w_c = random.randint(0, w - crop[1])
        for m in modalities:
            blob[m] = blob[m][h_c:h_c + crop[1], w_c:w_c + crop[1], ...]

    if hflip and hflip > random.random() and np.random.choice([0, 1]):
        for m in modalities:
            blob[m] = np.flip(blob[m], axis=0)

    if vflip and vflip > random.random() and np.random.choice([0, 1]):
        for m in modalities:
            blob[m] = np.flip(blob[m], axis=1)

    if contrast and "rgb" in modalities and contrast[0] > random.random():
        alpha = random.uniform(contrast[1], contrast[2])
        rgb = blob["rgb"].astype(np.float32)
        blob["rgb"] = np.clip((rgb - 128.0) * alpha + 128.0, 0, 255).astype(
            blob["rgb"].dtype)

    if brightness and "rgb" in modalities and brightness[0] > random.random():
        add = random.uniform(brightness[1], brightness[2])
        rgb = blob["rgb"].astype(np.float32) + add
        blob["rgb"] = np.clip(rgb, 0, 255).astype(blob["rgb"].dtype)

    if gamma and "rgb" in modalities and gamma[0] > random.random():
        k = random.uniform(gamma[1], gamma[2])
        lut = np.array([((i / 255.0) ** (1 / k)) * 255
                        for i in np.arange(0, 256)]).astype("uint8")
        if blob["rgb"].dtype == np.uint8:
            blob["rgb"] = native_backend.apply_lut(blob["rgb"], lut)
        else:
            blob["rgb"] = lut[blob["rgb"].astype(np.uint8)]

    if label_flip:
        blob["labels"] = flip_labels(blob["labels"], *label_flip)

    if label_merge:
        blob["labels"][blob["labels"] == label_merge[1]] = label_merge[0]

    return blob


def crop_multiple(data, multiple_of=16):
    """Crop the first two dimensions to a multiple of ``multiple_of`` (the
    VGG pooling alignment)."""
    try:
        h, w = data.shape[0], data.shape[1]
    except (AttributeError, IndexError):
        return data
    if not hasattr(data, "ndim") or data.ndim < 2:
        return data
    h_c, w_c = [d - (d % multiple_of) for d in [h, w]]
    if h_c != h or w_c != w:
        return data[:h_c, :w_c, ...]
    return data
