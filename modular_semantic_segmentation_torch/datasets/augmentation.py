"""Host-side image augmentation in numpy (the port's copy of the parts of
the JAX package's ``datasets/augmentation.py`` that need no cv2).

``augmentate`` draws from Python's ``random`` and numpy's global generator
in the JAX package's order, so that the same seeds give the same blob, and
keeps its quirks: 'hflip' flips axis 0 and 'vflip' axis 1, each gated by
its probability and a further coin toss. Its ``scale``, ``rotate`` and
``shear`` resize or warp through cv2, which the GPU machine does not have:
here they raise ``NotImplementedError`` (ROADMAP.md, section 1, item A3).
"""

import math
import random

import numpy as np

_NEEDS_CV2 = ("scale", "rotate", "shear")


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
    for name, value in (("scale", scale), ("rotate", rotate),
                        ("shear", shear)):
        if value:
            raise NotImplementedError(
                f"augmentation '{name}' needs cv2's resize or warp, which "
                "the port has not re-expressed yet (ROADMAP.md, section 1, "
                "item A3)")
    modalities = list(blob.keys())

    do_crop = bool(crop) and crop[0] > random.random()
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
