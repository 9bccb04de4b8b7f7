"""The port's native host ops (``datasets/native_backend``) against the JAX
package's library and against cv2, and the worker pool of
``DataSource.batches``.

The port builds its own copy of ``host_ops.cc`` with g++; the JAX
package's library is built here as its own test builds it (``make -C``).
Resize, LUT and pack equal the JAX package's bit for bit. Against cv2 they
are held at the JAX package's tolerances (tests/test_native_backend.py):
nearest resize, LUT and pack exact; the bilinear resize (float weights
where cv2 quantizes them to 11 bits) at most one uint8 step apart, on
under 20% of pixels. Pooled batches equal the sequential ones, in order.
"""

import os
import subprocess
import sys
import threading

import cv2
import numpy as np
import pytest

import modular_semantic_segmentation_tpu as jax_pkg
from modular_semantic_segmentation_tpu.datasets import \
    native_backend as jax_native
from modular_semantic_segmentation_torch.datasets import (
    get_dataset, native_backend)

BILINEAR_CASES = [((37, 53, 3), (2.0, 2.0)), ((64, 48, 3), (0.6, 0.6)),
                  ((33, 41, 1), (1.7, 0.9)), ((760, 1280, 3), (0.5, 0.5)),
                  ((31, 45), (0.77, 1.3))]


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's library, built with its Makefile if it is not."""
    if not jax_native.available():
        native_dir = os.path.join(os.path.dirname(jax_pkg.__file__),
                                  "native")
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True)
        jax_native._TRIED = False
        jax_native._LIB = None
    assert jax_native.available(), "the JAX package's library did not build"


def test_build_names_the_source_hash_and_reuses_it():
    path = native_backend.build()
    assert os.path.basename(path).startswith("host_ops-")
    assert path == native_backend.library_path()
    mtime = os.path.getmtime(path)
    assert native_backend.build() == path
    assert os.path.getmtime(path) == mtime


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "host_ops.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_backend, "SOURCE", str(broken))
    monkeypatch.setattr(native_backend, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed"):
        native_backend.build()


@pytest.mark.parametrize("shape,factors", BILINEAR_CASES)
def test_bilinear_resize_matches_jax_and_cv2(shape, factors):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    fy, fx = factors
    got = native_backend.resize(img, fx=fx, fy=fy,
                                interpolation=native_backend.INTER_LINEAR)
    want = jax_native.resize(img, fx=fx, fy=fy,
                             interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref = cv2.resize(img, None, fx=fx, fy=fy,
                     interpolation=cv2.INTER_LINEAR).reshape(got.shape)
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.2


def test_bilinear_resize_to_a_size_matches_cv2():
    """``dsize`` as the drivers pass it (SYNTHIA's 1280x760 -> 640x380,
    the 768x384 option): cv2's size and factors, within one step."""
    rng = np.random.RandomState(1)
    for shape, dsize in (((760, 1280, 3), (640, 380)),
                         ((101, 150, 3), (768, 384))):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = native_backend.resize(img, dsize=dsize,
                                    interpolation=native_backend.INTER_LINEAR)
        ref = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
        assert got.shape == ref.shape
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.2


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32,
                                   np.float32])
def test_nearest_resize_matches_jax_and_cv2(dtype):
    rng = np.random.RandomState(1)
    img = (rng.rand(29, 31) * 100).astype(dtype)
    for fy, fx in [(2.0, 2.0), (0.5, 0.7), (1.3, 1.3)]:
        got = native_backend.resize(img, fx=fx, fy=fy,
                                    interpolation=native_backend.INTER_NEAREST)
        np.testing.assert_array_equal(got, jax_native.resize(
            img, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(got, cv2.resize(
            img, None, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST))
    got = native_backend.resize(img, dsize=(47, 13),
                                interpolation=native_backend.INTER_NEAREST)
    np.testing.assert_array_equal(got, cv2.resize(
        img, (47, 13), interpolation=cv2.INTER_NEAREST))


def test_nearest_resize_keeps_a_channel_axis_as_jax():
    img = np.random.RandomState(2).randint(0, 256, (20, 24, 1)).astype(
        np.uint16)
    got = native_backend.resize(img, fx=1.5, fy=0.8,
                                interpolation=native_backend.INTER_NEAREST)
    want = jax_native.resize(img, fx=1.5, fy=0.8,
                             interpolation=cv2.INTER_NEAREST)
    assert got.shape == want.shape == (16, 36, 1)
    np.testing.assert_array_equal(got, want)


def test_unsupported_resizes_raise():
    with pytest.raises(NotImplementedError, match="float32"):
        native_backend.resize(np.zeros((4, 4), np.float32), 2.0, 2.0,
                              native_backend.INTER_LINEAR)
    with pytest.raises(ValueError, match="empty"):
        native_backend.resize(np.zeros((4, 4), np.uint8), 0.1, 0.1,
                              native_backend.INTER_LINEAR)


def test_apply_lut_matches_jax_and_cv2():
    img = np.random.RandomState(3).randint(0, 256, (50, 60, 3)).astype(
        np.uint8)
    lut = np.array([((i / 255.0) ** (1 / 0.7)) * 255
                    for i in np.arange(0, 256)]).astype("uint8")
    got = native_backend.apply_lut(img, lut)
    np.testing.assert_array_equal(got, jax_native.apply_lut(img, lut))
    np.testing.assert_array_equal(got, cv2.LUT(img, lut))
    with pytest.raises(TypeError):
        native_backend.apply_lut(img.astype(np.int32), lut)


def test_pack_normalize_matches_jax_and_numpy():
    img = np.random.RandomState(4).randint(0, 256, (4, 30, 40, 3)).astype(
        np.uint8)
    got = native_backend.pack_normalize(img, scale=1 / 255.0, offset=-0.5)
    np.testing.assert_array_equal(
        got, jax_native.pack_normalize(img, scale=1 / 255.0, offset=-0.5))
    np.testing.assert_array_equal(
        got, img.astype(np.float32) * np.float32(1 / 255.0)
        + np.float32(-0.5))
    # a strided view packs as its contiguous copy
    np.testing.assert_array_equal(native_backend.pack_normalize(img[:, ::2]),
                                  img[:, ::2].astype(np.float32))
    with pytest.raises(TypeError):
        native_backend.pack_normalize(img.astype(np.int32))


def _uint8_blobs(src, count=3):
    rng = np.random.RandomState(6)
    return [{m: (rng.randint(0, 256, (8, 10, 3)).astype(np.uint8)
                 if m == "rgb"
                 else rng.rand(8, 10, 1).astype(np.float32) if m == "depth"
                 else rng.randint(0, 4, (8, 10)).astype(np.int32))
             for m in src.modalities} for _ in range(count)]


def test_stack_packs_uint8_as_jax():
    from modular_semantic_segmentation_tpu.datasets import \
        get_dataset as jax_dataset
    ours = get_dataset("unittest")().get_trainset()
    theirs = jax_dataset("unittest")().get_trainset()
    blobs = _uint8_blobs(ours)
    for compact in (False, True):
        ours.compact_transfer = theirs.compact_transfer = compact
        got, want = ours.stack(blobs), theirs.stack(blobs)
        for m in want:
            assert got[m].dtype == want[m].dtype, (m, compact)
            np.testing.assert_array_equal(got[m], want[m])


@pytest.mark.parametrize("workers", [2, 3])
def test_pooled_batches_match_sequential(workers):
    """Worker-pool assembly yields the sequential batches, in order (same
    seed, no augmentation, so the shared generators are not drawn)."""
    src = get_dataset("unittest")().get_trainset(training_format=False)
    seq = list(src.batches(4, shuffle=True, seed=7))
    pooled = list(src.batches(4, shuffle=True, seed=7, workers=workers))
    assert len(seq) == len(pooled)
    for a, b in zip(seq, pooled):
        for m in a:
            np.testing.assert_array_equal(a[m], b[m])


def test_pool_under_thread_pressure():
    """More workers than cores, a short switch interval and an early stop:
    every batch equals the sequential one, and no worker is left."""
    src = get_dataset("unittest")(num_train=40).get_trainset(
        training_format=False)
    cores = os.cpu_count() or 1
    seq = list(src.batches(3, shuffle=True, seed=2))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = threading.active_count()
    try:
        pooled = src.batches(3, shuffle=True, seed=2, workers=2 * cores + 1)
        for i, (a, b) in enumerate(zip(seq, pooled)):
            for m in a:
                np.testing.assert_array_equal(a[m], b[m])
            if i == len(seq) // 2:
                break
        pooled.close()
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == before
