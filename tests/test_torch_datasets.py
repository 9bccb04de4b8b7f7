"""The port's dataset layer against the JAX package's, on the CPU.

``UnittestData`` blobs, splits, seeded shuffles and batch orders must be
equal bit for bit, with the same dtypes (with and without
``compact_transfer``); the sklearn-free ``train_test_split`` must give
sklearn's indices; ``augmentate`` (the parts without cv2) must give JAX's
blob under the same ``random.seed`` and ``np.random.seed``, and its cv2
parts refuse what cv2 refuses. A model scores a compact source (int8
labels) as it scores the plain one.
"""

import random

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from modular_semantic_segmentation_tpu.datasets import augmentation as jaug
from modular_semantic_segmentation_tpu.datasets import \
    get_dataset as jax_dataset
from modular_semantic_segmentation_torch.datasets import (
    augmentation as aug, data_baseclass, get_dataset)
from modular_semantic_segmentation_torch.models import get_model

SIZES = [{"height": 32, "width": 48}, {"height": 80, "width": 64}]
MODES = [{}, {"complementary": True}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX is loaded in the same
    process (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**config):
    return get_dataset("unittest")(**config), jax_dataset("unittest")(
        **config)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_unittest_blobs_equal_jax(size, mode):
    ours, theirs = _pair(num_train=5, num_measure=3, num_test=3, **size,
                         **mode)
    assert ours.num_classes == theirs.num_classes
    assert ours.labelinfo == theirs.labelinfo
    for name in ("trainset", "measureset", "testset", "validation_set"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for getter in ("get_trainset", "get_measureset", "get_testset",
                   "get_validation_set"):
        for a, b in zip(getattr(ours, getter)(), getattr(theirs, getter)()):
            for k in ("rgb", "depth", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_data_description_matches_jax():
    for num_classes in (None, 5, 9):
        ours = get_dataset("unittest").get_data_description(num_classes)
        theirs = jax_dataset("unittest").get_data_description(num_classes)
        assert ours == theirs


@pytest.mark.parametrize("num_train", [6, 20, 40])
def test_splits_and_shuffle_match_jax(num_train):
    """The validation split (for a dataset that gives none: sklearn's with
    the reference's seed) and the seeded trainset shuffle."""
    items = [{"idx": i} for i in range(num_train)]
    ours = data_baseclass.DataBaseclass.__new__(data_baseclass.DataBaseclass)
    from modular_semantic_segmentation_tpu.datasets import data_baseclass \
        as jbase
    theirs = jbase.DataBaseclass.__new__(jbase.DataBaseclass)
    for obj in (ours, theirs):
        obj._num_default_classes = 4
        obj._data_shape_description = {"rgb": (None, None, 3),
                                       "labels": (None, None)}
    data_baseclass.DataBaseclass.__init__(ours, list(items), [], [], {})
    jbase.DataBaseclass.__init__(theirs, list(items), [], [], {})
    assert ours.trainset == theirs.trainset
    assert ours.validation_set == theirs.validation_set


@pytest.mark.parametrize("n", [2, 3, 7, 8, 16, 31, 100])
@pytest.mark.parametrize("test_size", [0.5, 0.25, 0.9, 1])
@pytest.mark.parametrize("seed", [1, 317243896])
def test_train_test_split_matches_sklearn(n, test_size, seed):
    """Equal lists, or both refuse (a split that leaves no train item)."""
    items = [{"idx": i} for i in range(n)]
    try:
        want = sk_split(items, test_size=test_size, random_state=seed)
    except ValueError:
        with pytest.raises(ValueError):
            data_baseclass.train_test_split(items, test_size=test_size,
                                            random_state=seed)
        return
    got = data_baseclass.train_test_split(items, test_size=test_size,
                                          random_state=seed)
    assert list(got) == [list(w) for w in want]


def test_train_test_split_int_sizes_match_sklearn():
    for n in (16, 20, 33):
        items = list(range(n))
        for test_size in (1, 5, 15):
            want = sk_split(items, test_size=test_size, random_state=3)
            got = data_baseclass.train_test_split(items, test_size,
                                                  random_state=3)
            assert list(got) == [list(w) for w in want]
    with pytest.raises(ValueError):
        data_baseclass.train_test_split(list(range(4)), test_size=4)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shuffle,repeat,seed", [
    (False, False, None), (True, False, 5), (True, True, 9)])
def test_batches_match_jax(compact, shuffle, repeat, seed):
    """The batch order for a seed, the partial last batch, the top-up of
    repeated epochs, and the stacked dtypes (int8 labels when compact)."""
    ours, theirs = _pair(num_train=7, height=32, width=32)
    sources = []
    for data in (ours, theirs):
        src = data.get_trainset()
        src.compact_transfer = compact
        sources.append(src)
    take = 6 if repeat else None
    got, want = ([b for _, b in zip(range(take or 99), s.batches(
        3, shuffle=shuffle, repeat=repeat, seed=seed))] for s in sources)
    _assert_batches_equal(got, want)
    assert got[0]["labels"].dtype == (np.int8 if compact else np.int32)
    assert got[0]["rgb"].dtype == np.float32
    _assert_batches_equal([sources[0].as_dict()], [sources[1].as_dict()])


def test_uint8_frames_stack_like_jax():
    """A uint8 modality: float32 when stacked plainly, uint8 when
    compact, as the JAX package stacks it."""
    ours, theirs = _pair(num_train=3, height=32, width=32)
    blobs = [{"rgb": np.full((32, 32, 3), i * 40, np.uint8),
              "depth": np.ones((32, 32, 1), np.float32),
              "labels": np.full((32, 32), i, np.int32)} for i in range(3)]
    for compact in (False, True):
        out = []
        for data in (ours, theirs):
            src = data.get_testset()
            src.compact_transfer = compact
            out.append(src.stack(blobs))
        _assert_batches_equal([out[0]], [out[1]])


def test_score_on_a_compact_source():
    """int8 labels and the plain int32 ones give the same confusion
    matrix (kernel A's plain version widens them)."""
    data = get_dataset("unittest")(num_test=3, height=32, width=32)
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb", num_units=4, channel_factor=0.25,
        data_description=data.get_data_description(), batchsize=2,
        device="cpu")
    plain, compact = data.get_testset(), data.get_testset()
    compact.compact_transfer = True
    assert next(compact.batches(2))["labels"].dtype == np.int8
    m1, cm1 = net.score(plain)
    m2, cm2 = net.score(compact)
    np.testing.assert_array_equal(cm1, cm2)
    assert cm1.sum() == sum((b["labels"] >= 0).sum() for b in plain)
    assert m1["mean_IoU"] == m2["mean_IoU"] or np.isnan(m1["mean_IoU"])


def _blob(seed, size=40):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(size, size + 8, 3) * 255).astype(np.uint8),
            "depth": rng.rand(size, size + 8, 1).astype(np.float32),
            "labels": rng.randint(0, 5, (size, size + 8)).astype(np.int32)}


AUGMENTATIONS = [
    {"crop": (1.0, 32)},
    {"crop": (0.5, 24), "hflip": 0.7, "vflip": 0.7},
    {"hflip": 1.0, "vflip": 1.0, "contrast": (1.0, 0.5, 1.5)},
    {"brightness": (1.0, -40, 40), "gamma": (1.0, 0.5, 2.0)},
    {"crop": (1.0, 16), "contrast": (0.5, 0.8, 1.2),
     "brightness": (0.5, -10, 10), "gamma": (0.5, 0.8, 1.5),
     "label_flip": (1, 2), "label_merge": (0, 4)},
]


@pytest.mark.parametrize("config", AUGMENTATIONS)
def test_augmentate_matches_jax(config):
    for seed in range(6):
        out = []
        for module in (aug, jaug):
            random.seed(seed)
            np.random.seed(seed)
            out.append(module.augmentate(_blob(seed), **config))
            out[-1]["draw"] = np.array([random.random(),
                                        np.random.rand()])
        _assert_batches_equal([out[0]], [out[1]])


@pytest.mark.parametrize("name,value", [("scale", (1.0, 0.8, 1.2)),
                                        ("rotate", (1.0, -10, 10)),
                                        ("shear", (1.0, 0.1, 0.2))])
def test_augmentate_refuses_the_cv2_parts(name, value):
    """The cv2 parts run without cv2 now (tests/
    test_torch_host_augmentation.py holds them against JAX's); what they
    refuse is what cv2 refuses: a bilinear warp (rotate) of int32
    labels."""
    random.seed(0)
    np.random.seed(0)
    if name == "rotate":
        with pytest.raises(ValueError, match="int32"):
            aug.augmentate(_blob(0), crop=(1.0, 32), **{name: value})
        blob = _blob(0)
        blob["labels"] = blob["labels"].astype(np.uint8)
    else:
        blob = _blob(0)
    out = aug.augmentate(blob, crop=(1.0, 32), **{name: value})
    assert out["rgb"].shape == (32, 32, 3) and out["rgb"].dtype == np.uint8
    assert out["labels"].shape == (32, 32)


def test_augmentation_helpers_match_jax():
    image = np.arange(50 * 70 * 2).reshape(50, 70, 2)
    for w, h, angle in ((70, 50, 0.3), (50, 70, 1.2), (64, 64, 2.5),
                        (40, 10, 0.05), (10, 40, 0.0)):
        assert aug.largest_rotated_rect(w, h, angle) == \
            jaug.largest_rotated_rect(w, h, angle)
        rect = aug.largest_rotated_rect(w, h, angle)
        np.testing.assert_array_equal(aug.crop_around_center(image, *rect),
                                      jaug.crop_around_center(image, *rect))
    for shape in ((50, 70), (64, 48, 3), (15, 40), (7,)):
        data = np.zeros(shape)
        assert aug.crop_multiple(data).shape == jaug.crop_multiple(
            data).shape
    for seed in range(4):
        labels = np.random.RandomState(seed).randint(0, 5, (8, 8))
        np.random.seed(seed)
        got = aug.flip_labels(labels.copy(), 1, 3)
        np.random.seed(seed)
        np.testing.assert_array_equal(got, jaug.flip_labels(labels.copy(),
                                                            1, 3))


def test_augmented_trainset_matches_jax():
    """A training-format source draws the same augmentation per blob."""
    config = {"num_train": 4, "height": 48, "width": 48, "augmentation": {
        "crop": (1.0, 32), "hflip": 0.5, "vflip": 0.5,
        "brightness": (0.5, -20, 20)}}
    ours, theirs = _pair(**config)
    batches = []
    for data in (ours, theirs):
        random.seed(7)
        np.random.seed(7)
        batches.append(list(data.get_trainset().batches(2, shuffle=True,
                                                        seed=1)))
    _assert_batches_equal(*batches)


def test_registry():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_dataset("pascalvoc")
    for name in ("synthia", "cityscapes", "toydata", "mixeddata",
                 "add_random_objects"):
        assert get_dataset(name).__name__ == jax_dataset(name).__name__
    with pytest.raises(UserWarning, match="not found"):
        get_dataset("nonexistent")
    from modular_semantic_segmentation_torch.datasets import (
        Synthia, UnittestData)
    assert UnittestData is get_dataset("unittest")
    assert Synthia is get_dataset("synthia")
    with pytest.raises(NotImplementedError):
        from modular_semantic_segmentation_torch.datasets import \
            PascalVOC  # noqa: F401
