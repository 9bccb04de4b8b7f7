"""The port's PascalVOC driver against the JAX package's, on the same
seeded VOC-shaped tree, on the CPU, bit for bit.

The tree holds real cv2-written JPEG frames at two of VOC's sizes
(375x500 and 500x375) and, as the JAX package's own driver test writes
them, PNG bytes under a ``.jpg`` name; the labels are 8-bit palette PNGs
in VOC's own form (VOC's colour map, class blobs, a void border of index
255, colour 224,224,192, that maps to -1, and one colour outside the 21
classes). Checked: the train / measure / test / validation membership,
every test-format blob, training-format blobs under the same ``random``
and ``np.random`` seeds, ``batches(2, shuffle=True, seed=1)``, the
``in_memory`` branch with a ``pascalvoc.tar.gz`` and ``TMPDIR``, and an
rgb SimpleFCN's ``score`` of a 375x500 frame (native size, cut to 368x496)
against JAX's on the same weights.
"""

import os
import random
import subprocess
import tarfile

import cv2
import numpy as np
import pytest
import torch

import modular_semantic_segmentation_tpu as jax_pkg
from chip_smoke import voc_colormap, voc_label, write_palette_png
from modular_semantic_segmentation_tpu.datasets import \
    native_backend as jax_native
from modular_semantic_segmentation_tpu.datasets.pascalvoc import \
    PascalVOC as JaxPascalVOC
from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.datasets.pascalvoc import (
    LABELINFO, PascalVOC)
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables

SPLITS = ("trainset", "measureset", "testset", "validation_set")
GETTERS = ("get_trainset", "get_measureset", "get_testset",
           "get_validation_set")
TRAIN = [f"2007_{i:06d}" for i in range(8)]
VAL = [f"2008_{i:06d}" for i in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX is loaded in the same
    process (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's native library, so that its host augmentation
    resizes as the port's does."""
    if not jax_native.available():
        native_dir = os.path.join(os.path.dirname(jax_pkg.__file__),
                                  "native")
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True)
        jax_native._TRIED = False
        jax_native._LIB = None
    assert jax_native.available()


def voc_frame(rng, index):
    """A frame that follows its labels, with gradients and noise."""
    height, width = index.shape
    y, x = np.mgrid[0:height, 0:width]
    base = np.stack([x * 200 // width, y * 200 // height,
                     (x + y) % 96], -1)
    img = base + (index[..., None].astype(np.int64) * 37) % 256 // 2
    img = img + rng.randint(0, 24, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_voc_tree(base, train, val, sizes, rng, png_frames=()):
    """A VOC tree under ``base``: JPEG frames of ``sizes`` (in turn),
    palette labels (chip_smoke's, as phase 21 writes them); the names in
    ``png_frames`` hold 48x48 PNG bytes under their ``.jpg`` name."""
    os.makedirs(os.path.join(base, "ImageSets", "Segmentation"),
                exist_ok=True)
    for fileset, names in (("train", train), ("val", val)):
        with open(os.path.join(base, "ImageSets", "Segmentation",
                               f"{fileset}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    palette = voc_colormap()
    for sub in ("JPEGImages", "SegmentationClass"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i, name in enumerate(train + val):
        height, width = (48, 48) if name in png_frames else \
            sizes[i % len(sizes)]
        index = voc_label(rng, height, width)
        frame = voc_frame(rng, index)
        ext = ".png" if name in png_frames else ".jpg"
        data = cv2.imencode(ext, frame, [cv2.IMWRITE_JPEG_QUALITY, 90]
                            if ext == ".jpg" else [])[1].tobytes()
        with open(os.path.join(base, "JPEGImages", f"{name}.jpg"),
                  "wb") as f:
            f.write(data)
        write_palette_png(os.path.join(base, "SegmentationClass",
                                       f"{name}.png"), index, palette)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("voc"))
    write_voc_tree(base, TRAIN, VAL, [(375, 500), (500, 375)],
                   np.random.RandomState(3), png_frames={VAL[-1]})
    return base


def _assert_blobs_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def test_labels_map_as_jax(voc_tree):
    ours, theirs = PascalVOC(base_path=voc_tree), \
        JaxPascalVOC(base_path=voc_tree)
    for name in TRAIN[:2] + VAL:
        got, want = ours._load_data(name), theirs._load_data(name)
        _assert_blobs_equal(got, want, name)
        labels = got["labels"]
        assert labels.dtype == np.int32
        assert (labels == -1).any() and (labels > 0).any()
    # every colour of the palette: the 21 classes and -1 for the rest
    cmap = voc_colormap()[:, ::-1].reshape(16, 16, 3)
    np.testing.assert_array_equal(ours._map_colors(cmap),
                                  theirs._map_colors(cmap))
    assert sorted(set(ours._map_colors(cmap).ravel())) == \
        [-1] + list(range(21))
    void = np.array([[[192, 224, 224]]], np.uint8)  # BGR of 224,224,192
    assert ours._map_colors(void)[0, 0] == -1
    assert ours._color_lut == theirs._color_lut


def test_splits_and_blobs_match_jax(voc_tree):
    ours = get_dataset("pascalvoc")(base_path=voc_tree)
    theirs = JaxPascalVOC(base_path=voc_tree)
    for name in SPLITS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert len(ours.measureset) == 1 and len(ours.testset) == 3
    assert ours.labelinfo == theirs.labelinfo == LABELINFO
    assert ours.num_classes == theirs.num_classes == 21
    assert ours.config == theirs.config
    for getter in GETTERS:
        a, b = getattr(ours, getter)(), getattr(theirs, getter)()
        for i in range(len(b)):
            # the trainset's blobs are augmented: the same seeds
            _assert_blobs_equal(_seeded(lambda: a.get_blob(i), i),
                                _seeded(lambda: b.get_blob(i), i),
                                f"{getter} {i}")
    blob = ours.get_testset().get_blob(0)
    assert blob["rgb"].shape == (368, 496, 3)
    assert blob["rgb"].dtype == np.float32


def test_training_blobs_and_batches_match_jax(voc_tree):
    ours = PascalVOC(base_path=voc_tree)
    theirs = JaxPascalVOC(base_path=voc_tree)
    item = ours.trainset[0]
    for seed in range(4):
        _assert_blobs_equal(
            _seeded(lambda: ours._get_data(training_format=True, **item),
                    seed),
            _seeded(lambda: theirs._get_data(training_format=True, **item),
                    seed), f"seed {seed}")
    batches = [_seeded(lambda: list(d.get_trainset().batches(
        2, shuffle=True, seed=1)), 5) for d in (ours, theirs)]
    assert len(batches[0]) == len(batches[1]) == 4
    for got, want in zip(*batches):
        assert got["rgb"].shape[1:] == (240, 240, 3)
        _assert_blobs_equal(got, want, "batch")


def test_in_memory_matches_jax(voc_tree, tmp_path, monkeypatch):
    tree = str(tmp_path / "tree")
    write_voc_tree(tree, TRAIN[:3], VAL[:1], [(333, 500)],
                   np.random.RandomState(4))
    with tarfile.open(str(tmp_path / "pascalvoc.tar.gz"), "w:gz") as tar:
        tar.add(tree, arcname=".")
    extract = tmp_path / "extract"
    extract.mkdir()
    monkeypatch.setenv("TMPDIR", str(extract))
    ours = PascalVOC(base_path=str(tmp_path), in_memory=True)
    theirs = JaxPascalVOC(base_path=str(tmp_path), in_memory=True)
    assert ours.base_path == theirs.base_path == str(extract)
    assert len(ours.trainset) == 2 and len(ours.measureset) == 1
    for getter in GETTERS:
        a, b = getattr(ours, getter)(), getattr(theirs, getter)()
        assert len(a) == len(b)
        for i in range(len(b)):
            _assert_blobs_equal(_seeded(lambda: a.get_blob(i), i),
                                _seeded(lambda: b.get_blob(i), i),
                                f"{getter} {i}")


def test_score_of_a_native_size_frame_matches_jax(voc_tree):
    """An rgb SimpleFCN scores a 375x500 VOC frame at its native size (cut
    to 368x496), with the JAX model's weights: the confusion matrix is
    exact."""
    data_description = (
        {"labels": np.int32, "rgb": np.float32},
        {"rgb": (None, None, 3), "labels": (None, None)}, 21)
    config = {"num_units": 4, "channel_factor": 0.125, "batchsize": 1}
    jnet = jax_model("simple_fcn")(prefix="rgb", modality="rgb",
                                   data_description=data_description,
                                   **config)
    tnet = get_model("simple_fcn")(prefix="rgb", modality="rgb",
                                   data_description=data_description,
                                   device="cpu", **config)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    ours = PascalVOC(base_path=voc_tree)
    theirs = JaxPascalVOC(base_path=voc_tree)
    source = ours.get_testset()
    blob = source.get_blob(0)
    assert blob["labels"].shape == (368, 496)
    frame = {k: v[None] for k, v in blob.items()}
    assert tnet.predict(frame).shape == (1, 368, 496)
    (_, got), (_, want) = tnet.score(source), jnet.score(
        theirs.get_testset())
    np.testing.assert_array_equal(got, want)
    assert got.sum() == sum(
        ((b["labels"] >= 0) & (b["labels"] < 21)).sum() for b in source)
