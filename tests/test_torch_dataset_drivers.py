"""The port's file dataset drivers against the JAX package's, on the same
miniature trees (written with cv2, as the JAX package's own driver tests
write theirs), on the CPU.

For ``synthia``, ``raw_synthia``, ``synthia_rand``, ``synthia_cityscapes``
(with its in-memory mode), ``cityscapes``, ``cityscapes_a``,
``cityscapes_b``, ``toydata`` and ``mixeddata``:

* the splits are equal (train, measure, test and validation lists);
* the blobs are equal: labels and depth exact, rgb exact where it is read
  and where the host augmentation resizes it (both packages through the
  same native resize, JAX's library built here as its own test builds
  it); where JAX calls ``cv2.resize`` bilinearly itself (SYNTHIA's
  preprocessing, the drivers' 768x384 ``resize``) the port's native
  resize is within one uint8 step on under 20% of pixels
  (tests/test_native_backend.py's tolerance);
* training-format blobs are equal under the same ``random`` and
  ``np.random`` seeds, and where cv2 refuses (a rotation of int32 labels)
  the port refuses too.

SYNTHIA's split is unseeded, so JAX preprocesses the tree first and the
port reads it; the port's own preprocessing is held against JAX's on a
second copy of the raw frames. ``evaluation all_synthia`` runs through
both packages' CLIs on every sequence of ``AVAILABLE_SEQUENCES``.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import tarfile

import cv2
import numpy as np
import pytest
import torch

import modular_semantic_segmentation_tpu as jax_pkg
from modular_semantic_segmentation_tpu.datasets import \
    get_dataset as jax_dataset
from modular_semantic_segmentation_tpu.datasets import \
    native_backend as jax_native
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import (
    get_dataset, image_io)
from modular_semantic_segmentation_torch.datasets.synthia import \
    AVAILABLE_SEQUENCES
from modular_semantic_segmentation_torch.experiments import evaluation
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils import experiment as port_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("trainset", "measureset", "testset", "validation_set")
GETTERS = ("get_trainset", "get_measureset", "get_testset",
           "get_validation_set")
FRAMES = 6  # per sequence: the fewest that split 80/20 and then 50/50


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


def _write(path, image):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), image)


def _scene(rng, h, w, classes, block=20):
    """Labels in blocks, an rgb that follows them with noise."""
    blocks = rng.randint(0, classes, (h // block + 1, w // block + 1))
    labels = np.repeat(np.repeat(blocks, block, 0), block, 1)[:h, :w]
    rgb = (labels[..., None] * (250 // classes)
           + rng.randint(0, 8, (h, w, 3))).astype(np.uint8)
    return labels, rgb


def _assert_blobs_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _assert_same_draws(ours, theirs, seed, what):
    """``ours()`` and ``theirs()`` after the same ``random`` and
    ``np.random`` seeds give equal blobs; where JAX's cv2 raises (a
    rotation of int32 labels), the port raises ValueError. Returns
    whether they raised."""
    random.seed(seed)
    np.random.seed(seed)
    try:
        want = theirs()
    except cv2.error:
        random.seed(seed)
        np.random.seed(seed)
        with pytest.raises(ValueError, match="int32"):
            ours()
        return True
    random.seed(seed)
    np.random.seed(seed)
    _assert_blobs_equal(ours(), want, what)
    return False


def _assert_datasets_equal(ours, theirs, blobs=True):
    for name in SPLITS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.num_classes == theirs.num_classes
    assert ours.labelinfo == theirs.labelinfo
    if blobs:
        for getter in GETTERS:
            # the trainset's blobs are augmented: the same seeds
            sources = (getattr(ours, getter)(), getattr(theirs, getter)())
            for i in range(len(sources[1])):
                _assert_same_draws(lambda: sources[0].get_blob(i),
                                   lambda: sources[1].get_blob(i), i,
                                   f"{getter} {i}")


def _assert_close_rgb(got, want):
    """Within the native bilinear resize's tolerance of cv2's."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.2


def _training_blobs_equal(ours, theirs, seeds, **item):
    """Training-format blobs of one item under the same seeds (see
    _assert_same_draws). Returns how many raised."""
    return sum(_assert_same_draws(
        lambda: ours._get_data(training_format=True, **item),
        lambda: theirs._get_data(training_format=True, **item), seed,
        f"training seed {seed}") for seed in seeds)


# ----------------------------------------------------------------- SYNTHIA
def _write_sequence(base, sequence, rng, frames=FRAMES):
    seq = os.path.join(base, sequence)
    for i in range(frames):
        name = f"{i:06d}.png"
        labels, rgb = _scene(rng, 760, 1280, 14, block=40)
        crude = np.stack([labels, np.full_like(labels, 200),
                          np.full_like(labels, 100)], -1).astype(np.uint8)
        crude[:64, :64, 0] = 15  # the 15 -> 13 remap
        depth = rng.randint(0, 60000, (760, 1280)).astype(np.uint16)
        _write(os.path.join(seq, "RGB/Stereo_Right/Omni_F", name), rgb)
        _write(os.path.join(seq, "Depth/Stereo_Right/Omni_F", name), depth)
        _write(os.path.join(seq, "GT/LABELS/Stereo_Right/Omni_F", name),
               crude)


@pytest.fixture(scope="module")
def synthia_tree(tmp_path_factory):
    """Every sequence of AVAILABLE_SEQUENCES with FRAMES raw frames,
    preprocessed by the JAX package; and a second copy of the first
    sequence's raw frames, not preprocessed."""
    rng = np.random.RandomState(3)
    base = str(tmp_path_factory.mktemp("synthia"))
    for sequence in AVAILABLE_SEQUENCES:
        _write_sequence(base, sequence, rng)
    raw_copy = str(tmp_path_factory.mktemp("synthia_raw"))
    shutil.copytree(os.path.join(base, AVAILABLE_SEQUENCES[0]),
                    os.path.join(raw_copy, AVAILABLE_SEQUENCES[0]))
    jax_dataset("synthia")(base_path=base)
    return base, raw_copy


def test_synthia_matches_jax(synthia_tree):
    base, _ = synthia_tree
    seqs = AVAILABLE_SEQUENCES[:2]
    ours = get_dataset("synthia")(seqs=seqs, base_path=base)
    theirs = jax_dataset("synthia")(seqs=seqs, base_path=base)
    _assert_datasets_equal(ours, theirs)
    blob = ours.get_testset().get_blob(0)
    assert blob["rgb"].shape == (368, 640, 3)
    assert not (blob["labels"] == 15).any() and (blob["labels"] == 13).any()
    augmentation = {"crop": (1.0, 96), "scale": (1.0, 0.7, 1.5),
                    "hflip": 0.5, "gamma": (0.5, 0.3, 1.2)}
    ours = get_dataset("synthia")(seqs=seqs, base_path=base,
                                  augmentation=augmentation)
    theirs = jax_dataset("synthia")(seqs=seqs, base_path=base,
                                    augmentation=augmentation)
    _training_blobs_equal(ours, theirs, range(4), **ours.trainset[0])


def test_synthia_preprocessing_matches_jax(synthia_tree):
    base, raw_copy = synthia_tree
    sequence = AVAILABLE_SEQUENCES[0]
    get_dataset("synthia")(seqs=[sequence], base_path=raw_copy)
    ours, theirs = (os.path.join(b, sequence) for b in (raw_copy, base))
    names = sorted(os.listdir(os.path.join(theirs, "resized_rgb_F")))
    assert sorted(os.listdir(os.path.join(ours, "resized_rgb_F"))) == names
    for name in names:
        stem = name.split(".")[0]
        _assert_close_rgb(
            image_io.imread(os.path.join(ours, "resized_rgb_F", name)),
            cv2.imread(os.path.join(theirs, "resized_rgb_F", name)))
        np.testing.assert_array_equal(
            image_io.imread(os.path.join(ours, "resized_depth_F", name),
                            image_io.IMREAD_ANYDEPTH),
            cv2.imread(os.path.join(theirs, "resized_depth_F", name), 2))
        np.testing.assert_array_equal(
            np.load(os.path.join(ours, "resized_labels_F", f"{stem}.npy")),
            np.load(os.path.join(theirs, "resized_labels_F",
                                 f"{stem}.npy")))
    splits = []
    for root in (ours, theirs):
        with open(os.path.join(root, "train_test_split.json")) as f:
            splits.append(json.load(f))
    for split in splits:
        assert len(split["trainset"]) == 4 and len(split["testset"]) == 2
        assert sorted(split["trainset"] + split["testset"]) == [
            n.split(".")[0] for n in names]


def test_raw_synthia_matches_jax(synthia_tree):
    base, _ = synthia_tree
    seqs = AVAILABLE_SEQUENCES[:1]
    ours = get_dataset("raw_synthia")(seqs=seqs, base_path=base)
    theirs = jax_dataset("raw_synthia")(seqs=seqs, base_path=base)
    for name in SPLITS:
        assert getattr(ours, name) == getattr(theirs, name), name
    for getter in ("get_measureset", "get_testset"):
        _assert_blobs_equal(getattr(ours, getter)().get_blob(0),
                            getattr(theirs, getter)().get_blob(0), getter)
    assert ours.get_testset().get_blob(0)["rgb"].shape == (752, 1280, 3)
    _training_blobs_equal(ours, theirs, range(3), **ours.trainset[0])


def test_all_synthia_cli_matches_jax(synthia_tree, tmp_path, monkeypatch):
    """``evaluation all_synthia`` of both packages' CLIs on the same
    weights: every sequence scored, the measures equal (a near-tie pixel
    may move an IoU by far less than 1e-3)."""
    base, _ = synthia_tree
    description = get_dataset("synthia").get_data_description()
    net = get_model("simple_fcn")(prefix="rgb", modality="rgb",
                                  data_description=description, num_units=4,
                                  channel_factor=0.25, device="cpu", seed=2)
    weights = net.export_weights(str(tmp_path))
    net_config = {"prefix": "rgb", "modality": "rgb", "num_units": 4,
                  "channel_factor": 0.25, "batchsize": 1}
    data_config = {"dataset": "synthia", "base_path": base}
    store = tmp_path / "store"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               EXPERIMENT_STORAGE_FOLDER=str(store / "experiments"),
               EXP_OUT=str(store / "exp"), DATA_BASEPATH=str(store / "data"))
    argv = (["all_synthia", "with", "modelname=simple_fcn",
             f"starting_weights={json.dumps(weights)}"]
            + [f"net_config.{k}={json.dumps(v)}"
               for k, v in net_config.items()]
            + [f"evaluation_data.{k}={json.dumps(v)}"
               for k, v in data_config.items()])
    script = ("import sys\nfrom experiments import evaluation\n"
              "evaluation.ex.run_commandline(sys.argv[1:])\n"
              "print('RUN_ID', evaluation.ex.current_run._id)\n")
    out = subprocess.run([sys.executable, "-c", script] + argv,
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    jax_id = int(next(line.split()[1] for line in out.stdout.splitlines()
                      if line.startswith("RUN_ID")))
    for name, value in (("EXPERIMENT_STORAGE_FOLDER", "experiments"),
                        ("EXP_OUT", "exp")):
        monkeypatch.setattr(settings, name, str(store / value))
    monkeypatch.setattr(settings, "EXPERIMENT_DB_HOST", None)
    evaluation.ex.run("all_synthia", config_updates={
        "modelname": "simple_fcn", "starting_weights": weights,
        "net_config": net_config, "evaluation_data": data_config,
        "device": "cpu"})
    port_id = evaluation.ex.current_run._id
    assert port_id != jax_id
    theirs = port_exp.ExperimentData(jax_id).get_record()["info"][
        "measurements"]
    ours = port_exp.ExperimentData(port_id).get_record()["info"][
        "measurements"]
    assert sorted(ours) == sorted(theirs) == sorted(AVAILABLE_SEQUENCES)
    for sequence in AVAILABLE_SEQUENCES:
        for key in ("total_accuracy", "mean_IoU", "IoU"):
            np.testing.assert_allclose(
                np.asarray(ours[sequence][key], np.float64),
                np.asarray(theirs[sequence][key], np.float64), atol=1e-3,
                err_msg=f"{sequence} {key}")


# ------------------------------------------------ SYNTHIA-RAND (stills)
@pytest.fixture(scope="module")
def rand_tree(tmp_path_factory):
    """Miniature RAND_CITYSCAPES layout: 6 stills of 256x320 (room for
    the drivers' 240 crops), depth PNGs and npy labels of the 23 original
    classes."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("synthia_stills")
    base = root / "RAND_CITYSCAPES"
    names = [f"{i:07d}" for i in range(6)]
    for name in names:
        labels, rgb = _scene(rng, 256, 320, 23)
        _write(base / "RGB/Stereo_Right/Omni_F" / f"{name}.png", rgb)
        _write(base / "Depth/Stereo_Right/Omni_F" / f"{name}.png",
               rng.randint(0, 5000, (256, 320)).astype(np.uint16))
        os.makedirs(base / "GT/LABELS_NPY/Stereo_Right/Omni_F",
                    exist_ok=True)
        np.save(str(base / "GT/LABELS_NPY/Stereo_Right/Omni_F" / name),
                labels.astype(np.uint8))
    with open(base / "train_test_split.json", "w") as f:
        json.dump({"trainset": names[:4], "testset": names[4:]}, f)
    return str(root)


def test_synthia_rand_matches_jax(rand_tree):
    base = os.path.join(rand_tree, "RAND_CITYSCAPES")
    ours = get_dataset("synthia_rand")(base_path=base)
    theirs = jax_dataset("synthia_rand")(base_path=base)
    _assert_datasets_equal(ours, theirs)
    np.testing.assert_array_equal(ours.label_lookup, theirs.label_lookup)
    _training_blobs_equal(ours, theirs, range(6), **ours.trainset[0])


@pytest.mark.parametrize("config", [
    {}, {"labels": {"lanemarkings": True}}, {"resize": True}])
def test_synthia_cityscapes_matches_jax(rand_tree, config):
    ours = get_dataset("synthia_cityscapes")(base_path=rand_tree, **config)
    theirs = jax_dataset("synthia_cityscapes")(base_path=rand_tree,
                                               **config)
    if not config.get("resize"):
        _assert_datasets_equal(ours, theirs)
        raised = _training_blobs_equal(ours, theirs, range(12),
                                       **ours.trainset[0])
        # the default config rotates with probability 0.4: cv2 refuses
        # the bilinear warp of the int32 labels
        assert 0 < raised < 12
        return
    _assert_datasets_equal(ours, theirs, blobs=False)
    for getter in GETTERS[1:]:
        for a, b in zip(getattr(ours, getter)(), getattr(theirs, getter)()):
            assert a["rgb"].shape == (384, 768, 3)
            _assert_close_rgb(a["rgb"], b["rgb"])
            for k in ("depth", "labels"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthia_cityscapes_in_memory_matches_jax(rand_tree, tmp_path,
                                                  monkeypatch):
    with tarfile.open(os.path.join(rand_tree, "RAND_CITYSCAPES.tar.gz"),
                      "w:gz") as tar:
        tar.add(os.path.join(rand_tree, "RAND_CITYSCAPES"), arcname=".")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ours = get_dataset("synthia_cityscapes")(base_path=rand_tree,
                                             in_memory=True)
    theirs = jax_dataset("synthia_cityscapes")(base_path=rand_tree,
                                               in_memory=True)
    assert len(ours.trainset) == len(theirs.trainset) == 4
    for getter in GETTERS:
        sources = (getattr(ours, getter)(), getattr(theirs, getter)())
        for i in range(len(sources[1])):
            _assert_same_draws(lambda: sources[0].get_blob(i),
                               lambda: sources[1].get_blob(i), i,
                               f"{getter} {i}")


# -------------------------------------------------------------- Cityscapes
@pytest.fixture(scope="module")
def cityscapes_tree(tmp_path_factory):
    rng = np.random.RandomState(1)
    base = tmp_path_factory.mktemp("cityscapes")
    sets = {"train": ["aachen", "bochum", "ulm"],
            "val": ["munster", "frankfurt", "lindau"]}
    for fileset, cities in sets.items():
        for city in cities:
            for i in range(3):
                stem = f"{city}_{i:06d}_000019"
                labels, rgb = _scene(rng, 256, 320, 34)
                _write(base / "leftImg8bit_trainvaltest/leftImg8bit"
                       / fileset / city / f"{stem}_leftImg8bit.png", rgb)
                _write(base / "disparity_trainvaltest/disparity" / fileset
                       / city / f"{stem}_disparity.png",
                       rng.randint(0, 5000, (256, 320)).astype(np.uint16))
                _write(base / "gtFine_trainvaltest/gtFine" / fileset / city
                       / f"{stem}_gtFine_labelIds.png",
                       labels.astype(np.uint8))
    return str(base)


@pytest.mark.parametrize("config", [{}, {"resize": True}])
def test_cityscapes_matches_jax(cityscapes_tree, config):
    cities = ["aachen", "bochum", "ulm"]
    ours = get_dataset("cityscapes")(base_path=cityscapes_tree,
                                     cities=cities, **config)
    theirs = jax_dataset("cityscapes")(base_path=cityscapes_tree,
                                       cities=cities, **config)
    assert ours.label_lookup == theirs.label_lookup
    if config.get("resize"):
        _assert_datasets_equal(ours, theirs, blobs=False)
        a = ours.get_testset().get_blob(0)
        b = theirs.get_testset().get_blob(0)
        _assert_close_rgb(a["rgb"], b["rgb"])
        for k in ("depth", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    _assert_datasets_equal(ours, theirs)
    item = ours.testset[0]["image_path"]
    _assert_blobs_equal(ours.get_ego_vehicle_mask(item),
                        theirs.get_ego_vehicle_mask(item), "ego mask")
    _training_blobs_equal(ours, theirs, range(6), **ours.trainset[0])


def test_cityscapes_variants_match_jax(cityscapes_tree):
    for name in ("cityscapes_a", "cityscapes_b", "cityscapes_c"):
        ours = get_dataset(name)(base_path=cityscapes_tree)
        theirs = jax_dataset(name)(base_path=cityscapes_tree)
        _assert_datasets_equal(ours, theirs, blobs=False)
        _assert_blobs_equal(ours.get_measureset().get_blob(0),
                            theirs.get_measureset().get_blob(0), name)


# ------------------------------------------------------ toy and mixed data
def test_toydata_matches_jax():
    config = {"augmentation": {"label_flip": (0, 1, 0.4),
                               "label_merge": (2, 3)}}
    ours = get_dataset("toydata")(**config)
    theirs = jax_dataset("toydata")(**config)
    _assert_datasets_equal(ours, theirs, blobs=False)
    for training_format in (False, True):
        for dataset in (ours, theirs):
            np.random.seed(5)
            dataset.blobs = [dataset._get_data(
                "train", training_format=training_format)
                for _ in range(200)]
        for a, b in zip(ours.blobs, theirs.blobs):
            _assert_blobs_equal(a, b, f"toy {training_format}")
    np.random.seed(6)
    got = ours.get_testset().as_dict()
    np.random.seed(6)
    _assert_blobs_equal(got, theirs.get_testset().as_dict(), "toy testset")


def test_mixed_data_matches_jax():
    from modular_semantic_segmentation_tpu.datasets.mixed_data import \
        MixedData as JaxMixedData
    from modular_semantic_segmentation_torch.datasets.mixed_data import \
        MixedData
    assert get_dataset("mixeddata") is MixedData
    parts = {"height": 32, "width": 32, "num_train": 4}
    ours = MixedData([get_dataset("unittest")(**parts),
                      get_dataset("unittest")(**parts)], [2, 1])
    theirs = JaxMixedData([jax_dataset("unittest")(**parts),
                           jax_dataset("unittest")(**parts)], [2, 1])
    assert ours.num_classes == theirs.num_classes
    assert ours.modalities == theirs.modalities
    # the quota batches draw unseeded shuffles in both packages: their
    # shapes and dtypes, and each item from its dataset's trainset
    for scale, batchsize in ((1, 3), (2, 6)):
        got = next(ours.get_trainset().batches(batchsize, repeat=True))
        want = next(theirs.get_trainset().batches(batchsize, repeat=True))
        for k in want:
            assert got[k].shape == want[k].shape == (
                (batchsize,) + want[k].shape[1:])
            assert got[k].dtype == want[k].dtype
        train = ours.datasets[0].get_trainset().as_dict()["rgb"]
        for frame in got["rgb"]:
            assert any(np.array_equal(frame, t) for t in train)
    with pytest.raises(ValueError, match="multiple"):
        next(ours.get_trainset().batches(4, repeat=True))
    for getter in ("get_testset", "get_measureset", "get_validation_set"):
        _assert_blobs_equal(getattr(ours, getter)().as_dict(),
                            getattr(theirs, getter)().as_dict(), getter)
