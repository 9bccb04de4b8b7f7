"""The cv2 parts of host augmentation without cv2, against the JAX
package's ``augmentate`` and against cv2 itself.

``warp_affine`` must equal ``cv2.warpAffine`` (OpenCV 5.0, as installed)
exactly, with its shape and dtype, for the dtypes and channel counts the
drivers warp, on rotations as ``rotate_image`` builds them, on shears as
``augmentate`` builds them (a float32 matrix) and on random affine maps;
it refuses what cv2 refuses (a bilinear warp of int32). ``augmentate``
with ``scale``, ``rotate`` and ``shear`` (and the drivers' own configs)
must give JAX's blob bit for bit under the same ``random`` and
``np.random`` seeds: labels, depth and rgb. JAX's resizes run through
its native library, built here as its own test builds it; the port's
resizes are the same code.
"""

import math
import os
import random
import subprocess

import cv2
import numpy as np
import pytest

import modular_semantic_segmentation_tpu as jax_pkg
from modular_semantic_segmentation_tpu.datasets import augmentation as jaug
from modular_semantic_segmentation_tpu.datasets import \
    native_backend as jax_native
from modular_semantic_segmentation_torch.datasets import augmentation as aug

WARP_KINDS = [(np.uint8, 3), (np.uint8, 1), (np.uint8, 4), (np.uint16, 1),
              (np.uint16, "1x"), (np.float32, 1), (np.int32, 1),
              (np.int32, "1x"), (np.float64, 1)]


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's native library, so that its ``augmentate``
    resizes natively (as the port's does) instead of with cv2."""
    if not jax_native.available():
        native_dir = os.path.join(os.path.dirname(jax_pkg.__file__),
                                  "native")
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True)
        jax_native._TRIED = False
        jax_native._LIB = None
    assert jax_native.available()


def _image(rng, h, w, dtype, channels):
    c = 1 if channels == "1x" else channels
    if np.dtype(dtype).kind == "f":
        img = (rng.rand(h, w, c) * 100).astype(dtype)
    elif dtype == np.int32:
        img = rng.randint(-1, 30, (h, w, c)).astype(dtype)
    else:
        img = rng.randint(0, np.iinfo(dtype).max + 1, (h, w, c)).astype(
            dtype)
    return img[..., 0] if channels == 1 else img


def _maps(rng, h, w):
    """(matrix, width, height): a rotate_image rotation, an augmentate
    shear and a random affine map."""
    deg = int(rng.randint(-13, 13))
    center = (w / 2, h / 2)
    rot = cv2.getRotationMatrix2D(center, deg, 1.0)
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    new_w, new_h = int(h * sin + w * cos), int(h * cos + w * sin)
    rot[0, 2] += new_w / 2 - center[0]
    rot[1, 2] += new_h / 2 - center[1]
    yield rot, new_w, new_h
    shear = int(rng.randint(1, 10)) * int(rng.choice([-1, 1]))
    yield np.float32([[1, shear / h, 0], [0, 1, 0]]), w, h
    yield np.array([[rng.uniform(.5, 1.5), rng.uniform(-.3, .3),
                     rng.uniform(-5, 5)],
                    [rng.uniform(-.3, .3), rng.uniform(.5, 1.5),
                     rng.uniform(-5, 5)]]), w + 3, h - 2


def test_rotation_matrix_equals_cv2():
    for deg in list(range(-90, 91)) + list(np.linspace(-30, 30, 41)):
        for center in ((0.0, 0.0), (320.0, 184.0), (33.5, 20.0)):
            np.testing.assert_array_equal(
                aug.rotation_matrix(center, float(deg), 1.0),
                cv2.getRotationMatrix2D(center, float(deg), 1.0))


@pytest.mark.parametrize("dtype,channels", WARP_KINDS)
@pytest.mark.parametrize("flags", [cv2.INTER_LINEAR, cv2.INTER_NEAREST])
def test_warp_affine_equals_cv2(dtype, channels, flags):
    rng = np.random.RandomState(11)
    compared = 0
    for _ in range(12):
        h, w = rng.randint(10, 160), rng.randint(10, 160)
        img = _image(rng, h, w, dtype, channels)
        for matrix, width, height in _maps(rng, h, w):
            try:
                want = cv2.warpAffine(img, matrix, (width, height),
                                      flags=flags)
            except cv2.error:
                # cv2 refuses a bilinear warp of int32: so does the port
                with pytest.raises(ValueError, match="int32"):
                    aug.warp_affine(img, matrix, (width, height), flags)
                continue
            if (dtype, flags) == (np.float64, cv2.INTER_LINEAR):
                # not a dtype any driver warps bilinearly: refused
                with pytest.raises(ValueError, match="not supported"):
                    aug.warp_affine(img, matrix, (width, height), flags)
                continue
            got = aug.warp_affine(img, matrix, (width, height), flags)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            compared += 1
    refused = (dtype in (np.int32, np.float64)
               and flags == cv2.INTER_LINEAR)
    assert compared == (0 if refused else 36)


def test_warp_affine_block_boundary_and_large_frames():
    """Widths around cv2's vector block and a SYNTHIA-sized frame."""
    rng = np.random.RandomState(12)
    for w in (15, 16, 17, 31, 32, 33, 1280):
        h = 760 if w == 1280 else 23
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        rot = aug.rotation_matrix((w / 2, h / 2), 7.0, 1.0)
        np.testing.assert_array_equal(
            aug.warp_affine(img, rot, (w, h)),
            cv2.warpAffine(img, rot, (w, h), flags=cv2.INTER_LINEAR))


def test_rotate_image_equals_jax():
    rng = np.random.RandomState(13)
    for deg in (-13, -5, 1, 9, 12):
        for img in (rng.randint(0, 256, (48, 64, 3)).astype(np.uint8),
                    rng.randint(0, 60000, (48, 64, 1)).astype(np.uint16),
                    rng.randint(0, 14, (48, 64)).astype(np.uint8)):
            got, want = aug.rotate_image(img, deg), jaug.rotate_image(img,
                                                                      deg)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _blob(seed, labels_dtype=np.int32, size=(64, 72)):
    rng = np.random.RandomState(seed)
    h, w = size
    return {"rgb": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "depth": rng.randint(0, 60000, (h, w, 1)).astype(np.uint16),
            "labels": rng.randint(0, 14, (h, w)).astype(labels_dtype)}


CONFIGS = [
    {"crop": (1.0, 32), "scale": (1.0, 0.7, 1.5)},
    {"crop": (1.0, 32), "scale": (0.5, 0.4, 2.0), "hflip": 0.5,
     "vflip": 0.5},
    {"crop": (1.0, 24), "shear": (1.0, 0.05, 0.1)},
    {"crop": (0.7, 24), "shear": (0.7, 0.01, 0.03),
     "scale": (0.7, 0.7, 1.5), "gamma": (0.5, 0.3, 1.2)},
    {"rotate": (1.0, -13, 13)},
    {"crop": (1.0, 32), "rotate": (0.6, -13, 13), "scale": (0.6, 0.7, 1.5),
     "contrast": (0.5, 0.5, 1.5), "brightness": (0.5, -40, 40)},
]


@pytest.mark.parametrize("config", CONFIGS)
def test_augmentate_matches_jax(config):
    # rotate warps every modality bilinearly: int32 labels are refused by
    # cv2, so rotations take uint8 labels (the test below holds the
    # refusal)
    labels_dtype = np.uint8 if "rotate" in config else np.int32
    for seed in range(8):
        out = []
        for module in (aug, jaug):
            random.seed(seed)
            np.random.seed(seed)
            out.append(module.augmentate(_blob(seed, labels_dtype),
                                         **config))
            # the two packages drew the same number of times
            out[-1]["draw"] = np.array([random.random(), np.random.rand()])
        assert sorted(out[0]) == sorted(out[1])
        for key in out[1]:
            assert out[0][key].shape == out[1][key].shape, (key, seed)
            assert out[0][key].dtype == out[1][key].dtype, (key, seed)
            np.testing.assert_array_equal(out[0][key], out[1][key],
                                          err_msg=f"{key} {seed}")


def test_augmentate_refuses_the_rotation_of_int32_labels_as_jax():
    random.seed(0)
    np.random.seed(0)
    with pytest.raises(cv2.error):
        jaug.augmentate(_blob(0), rotate=(1.0, -13, 13))
    random.seed(0)
    np.random.seed(0)
    with pytest.raises(ValueError, match="int32"):
        aug.augmentate(_blob(0), rotate=(1.0, -13, 13))


def test_drivers_augmentation_configs_match_jax():
    """The training-format configs of RawSynthia / SynthiaRand (scale,
    crop, vflip, gamma) and Cityscapes (with contrast and brightness) at a
    SYNTHIA-like frame."""
    raw_synthia = {"scale": [.4, 0.7, 1.5], "crop": [1, 96],
                   "hflip": False, "vflip": .3, "gamma": [.4, 0.3, 1.2]}
    cityscapes = {"crop": [1, 96], "scale": [.4, 1, 1.5], "vflip": .3,
                  "hflip": False, "gamma": [.4, 0.3, 1.2], "rotate": False,
                  "shear": False, "contrast": [.3, 0.5, 1.5],
                  "brightness": [.2, -40, 40]}
    for config in (raw_synthia, cityscapes):
        for seed in range(6):
            out = []
            for module in (aug, jaug):
                random.seed(seed)
                np.random.seed(seed)
                out.append(module.augmentate(
                    _blob(seed, size=(190, 320)), **config))
            for key in out[1]:
                np.testing.assert_array_equal(out[0][key], out[1][key],
                                              err_msg=f"{key} {seed}")


def test_largest_rotated_rect_crop_equals_jax():
    for w, h, deg in ((1280, 760, 13), (640, 368, -7), (96, 96, 45)):
        rect = aug.largest_rotated_rect(w, h, math.radians(deg))
        assert rect == jaug.largest_rotated_rect(w, h, math.radians(deg))
