"""The port's AddRandomObjects (``datasets/not_cityscapes.py``) against the
JAX package's, on the CPU.

An object library of 8 non-square objects (26 wide, 18 high; textured
ellipses, dark and bright, on a black ground, with a row of 29 and one of
30 across each) is written with cv2 into a
temporary DATA_BASEPATH, as tests/test_uncertainty_gain.py writes its own,
and pasted onto 32x32 UnittestData frames under the same numpy seed.

Held: with ``halfsize=False`` the blobs equal JAX's bit for bit. With
``halfsize=True`` the port halves each object with the native bilinear
resize where JAX calls cv2: the halved objects (both 13 rows by 9 columns,
the dsize ``(h // 2, w // 2)`` read as (width, height)) are within one
uint8 step of cv2's on under 20% of pixels (ROADMAP.md section 3, item
15); such a step can move a pixel across the ``< 30`` background
threshold, and the blobs' labels with it. Given JAX's halved objects,
the port's blobs equal JAX's bit for bit, so labels differ only where the
two halved objects do.
"""

import os

import cv2
import numpy as np
import pytest

import modular_semantic_segmentation_tpu.datasets.not_cityscapes as jnc
from modular_semantic_segmentation_tpu.datasets import \
    get_dataset as jax_dataset
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.datasets import not_cityscapes

OBJECTS = range(251, 259)
BASE = {"add_to_dataset": "unittest", "height": 32, "width": 32,
        "num_train": 4, "num_measure": 4, "num_test": 12, "num_classes": 4}


def _write_library(base):
    rng = np.random.RandomState(2)
    lib = os.path.join(base, "amsterdam_object_lib")
    for num in OBJECTS:
        obj = np.zeros((18, 26, 3), np.uint8)
        mask = np.zeros((18, 26), np.uint8)
        cv2.ellipse(mask, (13, 9), (int(rng.randint(8, 12)),
                                    int(rng.randint(5, 8))),
                    int(rng.randint(180)), 0, 360, 1, -1)
        low = 10 if num % 2 else 120
        texture = rng.randint(low, low + 100, (18, 26, 3))
        obj[mask > 0] = texture[mask > 0]
        # rows on either side of the background threshold (< 30)
        obj[8, 6:20], obj[9, 6:20] = 29, 30
        os.makedirs(os.path.join(lib, str(num)), exist_ok=True)
        cv2.imwrite(os.path.join(lib, str(num), f"{num}_c.png"), obj)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("data"))
    _write_library(base)
    return base


@pytest.fixture
def data_basepath(library, monkeypatch):
    monkeypatch.setattr(settings, "DATA_BASEPATH", library)
    monkeypatch.setattr(jnc, "DATA_BASEPATH", library)
    return library


def _sets(get, halfsize, seed=5):
    np.random.seed(seed)
    data = get("add_random_objects")(halfsize=halfsize, **BASE)
    return data, {name: getattr(data, f"get_{name}")(tf_dataset=False)
                  for name in ("testset", "measureset")}


def _assert_blobs_equal(got, want):
    for name in want:
        for key in ("rgb", "labels"):
            assert got[name][key].dtype == want[name][key].dtype
            np.testing.assert_array_equal(got[name][key], want[name][key])


def test_registry_resolves(data_basepath):
    cls = get_dataset("add_random_objects")
    assert cls is not_cityscapes.AddRandomObjects
    assert cls.get_data_description() == \
        jax_dataset("add_random_objects").get_data_description()


def test_full_size_objects_match_jax_bit_for_bit(data_basepath):
    data, got = _sets(get_dataset, halfsize=False)
    _, want = _sets(jax_dataset, halfsize=False)
    _assert_blobs_equal(got, want)
    labels = got["testset"]["labels"]
    assert set(np.unique(labels)) == {0, 1}
    assert data.num_classes == 4
    assert data._object_ids == list(OBJECTS)


def test_halved_objects_within_one_step_of_cv2(data_basepath):
    data, _ = _sets(get_dataset, halfsize=True)
    jdata, _ = _sets(jax_dataset, halfsize=True)
    for num in OBJECTS:
        got, want = data._load_object(num), jdata._load_object(num)
        # the dsize (h // 2, w // 2) is (width, height): 13 rows, 9 columns
        assert got.shape == want.shape == (13, 9, 3)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.2


def test_halved_objects_paste_as_jax(data_basepath, monkeypatch):
    """Given JAX's halved objects the port's blobs equal JAX's bit for
    bit, so a label differs only where the two halved objects do. With
    its own, a pixel one step across the threshold takes the frame's rgb
    in one package and the object's in the other; elsewhere the rgb is
    within one uint8 step, and under 20% of pixels differ."""
    _, want = _sets(jax_dataset, halfsize=True)
    _, got = _sets(get_dataset, halfsize=True)
    relabelled = 0
    for name in want:
        same = got[name]["labels"] == want[name]["labels"]
        diff = np.abs(got[name]["rgb"] - want[name]["rgb"]).max(-1)
        assert diff[same].max() <= 1
        assert (diff > 0).mean() < 0.2
        relabelled += int((~same).sum())
    assert relabelled > 0  # the rows of 29 and 30 cross the threshold
    jdata = jax_dataset("add_random_objects")(halfsize=True, **BASE)
    monkeypatch.setattr(not_cityscapes.AddRandomObjects, "_load_object",
                        lambda self, num: jdata._load_object(num))
    _, got = _sets(get_dataset, halfsize=True)
    _assert_blobs_equal(got, want)


def test_last_object_never_sampled(data_basepath, monkeypatch):
    """The object draw is ``randint(len(pool) - 1)``, as the reference's
    ``randint(251, 1000)`` over the ids 251..1000."""
    data, _ = _sets(get_dataset, halfsize=False)
    drawn = []
    load = not_cityscapes.AddRandomObjects._load_object
    monkeypatch.setattr(not_cityscapes.AddRandomObjects, "_load_object",
                        lambda self, num: drawn.append(num) or load(self,
                                                                    num))
    np.random.seed(0)
    for _ in range(200):
        data._get_data(idx=20_000)
    assert set(drawn) == set(OBJECTS) - {max(OBJECTS)}


def test_missing_library_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "DATA_BASEPATH", str(tmp_path))
    with pytest.raises(IOError):
        get_dataset("add_random_objects")(**BASE)
