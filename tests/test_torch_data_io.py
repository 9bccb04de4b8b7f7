"""The prefetching loader (``utils/data_io``) against the JAX package's.

``prefetch_eval_batches`` yields what ``iterate_batches`` yields and what
JAX's ``prefetch_eval_batches`` yields; ``to_device_prefetched`` and
``training_batches(workers=...)`` yield JAX's batches in JAX's order; an
exception of the producer reaches the consumer (where JAX's loader ends
the stream silently); the producer thread stops when the iterator is
dropped or closed; and ``fit`` trains on a file dataset (SYNTHIA,
decoded without cv2) with ``loader_workers=2`` and on-device
augmentation on the CPU.
"""

import gc
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.datasets import \
    get_dataset as jax_dataset
from modular_semantic_segmentation_tpu.utils import data_io as jax_data_io
from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils import data_io

DATA = {"height": 32, "width": 48, "num_train": 7, "num_measure": 3,
        "num_test": 5}


def _as_numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("source", ["data source", "dict"])
def test_prefetch_eval_batches_yields_iterate_batches(source):
    ours = get_dataset("unittest")(**DATA).get_testset()
    theirs = jax_dataset("unittest")(**DATA).get_testset()
    if source == "dict":
        ours, theirs = ours.as_dict(), theirs.as_dict()
    plain = list(data_io.iterate_batches(ours, 2))
    prefetched = list(data_io.prefetch_eval_batches(ours, 2, "cpu"))
    jax_batches = list(jax_data_io.prefetch_eval_batches(theirs, 2))
    assert len(plain) == len(prefetched) == len(jax_batches) == 3
    for (p, pv), (q, qv), (j, jv) in zip(plain, prefetched, jax_batches):
        assert all(isinstance(v, torch.Tensor) for v in q.values())
        assert pv == qv == jv
        _assert_equal(_as_numpy(q), p)
        _assert_equal(_as_numpy(q), _as_numpy(j))
    assert (plain[-1][0]["labels"][1] == -1).all()  # the pad


@pytest.mark.parametrize("workers", [None, 3])
def test_training_batches_and_prefetch_match_jax(workers):
    ours = get_dataset("unittest")(**DATA).get_trainset()
    theirs = jax_dataset("unittest")(**DATA).get_trainset()
    got = data_io.to_device_prefetched(
        data_io.training_batches(ours, 2, seed=5, workers=workers), "cpu")
    want = jax_data_io.to_device_prefetched(
        jax_data_io.training_batches(theirs, 2, workers=workers, seed=5))
    for _ in range(9):  # past an epoch of 7 items
        _assert_equal(_as_numpy(next(got)), _as_numpy(next(want)))
    got.close()


def _failing(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.float32)}
    raise KeyError("producer failed")


@pytest.mark.parametrize("loader", ["fit", "score"])
def test_producer_exception_reaches_the_consumer(loader):
    if loader == "fit":
        batches = data_io.to_device_prefetched(_failing(3), "cpu")
    else:
        batches = data_io.prefetch_eval_batches(_failing(3), 2, "cpu")
    seen = []
    with pytest.raises(KeyError, match="producer failed"):
        for batch in batches:
            seen.append(batch)
    assert len(seen) == 3
    with pytest.raises(StopIteration):
        next(batches)
    # JAX's loader ends the stream instead
    assert len(list(jax_data_io.to_device_prefetched(_failing(3)))) == 3


def _endless():
    while True:
        yield {"x": np.zeros((2, 8), np.float32)}


def _wait_for(condition, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if condition():
            return True
        time.sleep(0.01)
    return False


def _new_threads(before):
    """Threads alive now that were not alive in ``before`` (threads other
    tests left may end meanwhile)."""
    return set(threading.enumerate()) - before


def test_producer_stops_when_the_iterator_is_dropped_or_closed():
    before = set(threading.enumerate())
    batches = data_io.to_device_prefetched(_endless(), "cpu")
    next(batches)
    assert len(_new_threads(before)) == 1
    del batches
    gc.collect()
    assert _wait_for(lambda: not _new_threads(before))
    batches = data_io.to_device_prefetched(_endless(), "cpu",
                                           buffer_size=1)
    next(batches)
    batches.close()
    assert not _new_threads(before)
    with pytest.raises(StopIteration):
        next(batches)


def test_pooled_source_behind_the_prefetcher_stops():
    src = get_dataset("unittest")(**DATA).get_trainset()
    before = set(threading.enumerate())
    batches = data_io.to_device_prefetched(
        data_io.training_batches(src, 2, seed=1, workers=3), "cpu")
    for _ in range(5):
        next(batches)
    assert len(_new_threads(before)) == 4  # the producer and its pool
    batches.close()
    assert not _new_threads(before)


SEQ = "SYNTHIA-SEQS-04-DAWN"


@pytest.fixture(scope="module")
def synthia_tree(tmp_path_factory):
    """Six 1280x760 frames of one raw SYNTHIA sequence, written with cv2:
    labels a function of the rgb, so that a model can learn them."""
    rng = np.random.RandomState(0)
    base = tmp_path_factory.mktemp("synthia")
    for i in range(6):
        blocks = rng.randint(0, 14, (760 // 40, 1280 // 40))
        labels = np.repeat(np.repeat(blocks, 40, 0), 40, 1).astype(np.uint8)
        rgb = (labels[..., None] * 18 + rng.randint(0, 6, (760, 1280, 3)))
        depth = rng.randint(0, 60000, (760, 1280)).astype(np.uint16)
        crude = np.stack([labels, np.full_like(labels, 200),
                          np.full_like(labels, 100)], -1)
        for sub, img in (("RGB/Stereo_Right/Omni_F", rgb.astype(np.uint8)),
                         ("Depth/Stereo_Right/Omni_F", depth),
                         ("GT/LABELS/Stereo_Right/Omni_F", crude)):
            os.makedirs(base / SEQ / sub, exist_ok=True)
            cv2.imwrite(str(base / SEQ / sub / f"{i:06d}.png"), img)
    return str(base)


def test_fit_on_synthia_with_workers_and_device_augmentation(synthia_tree):
    data = get_dataset("synthia")(seqs=[SEQ], base_path=synthia_tree)
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb",
        data_description=data.get_data_description(), num_units=4,
        channel_factor=0.25, batch_normalization=True, batchsize=2,
        device="cpu", loader_workers=2, trainer="adam",
        device_augmentation={"scale": (0.4, 0.7, 1.5), "hflip": 0.5,
                             "gamma": (0.4, 0.3, 1.2), "crop": (1.0, 64)})
    before = {k: v.clone() for k, v in net.variables.items()}
    threads = set(threading.enumerate())
    net.fit(data.get_trainset(), 3, output=False,
            validation_dataset=data.get_measureset(), validation_interval=2)
    assert net.global_step == 3
    assert any(not torch.equal(net.variables[k], before[k])
               for k in before if net.trainable[k])
    assert not _new_threads(threads)  # the loader's threads ended
    measures, confusion = net.score(data.get_testset())
    assert confusion.sum() == 368 * 640
    assert np.isfinite(measures["total_accuracy"])
