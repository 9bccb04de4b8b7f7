"""The plain PyTorch versions of the port's two CUDA kernels against the
JAX package's Pallas kernels (interpret mode) and XLA forms, on the CPU.

Both functions return labels or counts, so every comparison is exact. On
CPU tensors the wrappers must take the plain version and launch nothing.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.ops import fusion_math as jfm
from modular_semantic_segmentation_tpu.ops import metrics as jmetrics
from modular_semantic_segmentation_tpu.ops.pallas import confusion_kernel
from modular_semantic_segmentation_tpu.ops.pallas import dirichlet_kernel
from modular_semantic_segmentation_torch.ops import metrics as tmetrics
from modular_semantic_segmentation_torch.ops.cuda import confusion
from modular_semantic_segmentation_torch.ops.cuda import dirichlet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process.

    With both frameworks' CPU thread pools in one process, a chunk of a
    parallel float32 elementwise op (exp) was seen, in about one run of
    six, to come out at ~1e-5 relative error instead of a few ulp; on
    one thread it did not recur in 25 runs. Single-process runs of the
    port alone are not affected."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _confusion_inputs(seed=1, k=12):
    """Predictions and labels with -1 labels and values outside [0, K)."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(-1, k + 2, (3, 40, 40))
    labels = rng.randint(-2, k + 3, (3, 40, 40))
    return preds, labels, k


def test_confusion_plain_matches_xla_and_pallas():
    preds, labels, k = _confusion_inputs()
    got = confusion.confusion_matrix_plain(torch.from_numpy(preds),
                                           torch.from_numpy(labels), k)
    xla = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds),
                                               jnp.asarray(labels), k))
    pallas = np.asarray(confusion_kernel.confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), k, tile=1024,
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert got.dtype == torch.float32


def test_confusion_wrapper_takes_plain_version_on_cpu():
    preds, labels, k = _confusion_inputs(seed=2)
    confusion.KERNEL.launches = 0
    got = tmetrics.confusion_matrix(torch.from_numpy(preds),
                                    torch.from_numpy(labels), k)
    want = confusion.confusion_matrix_plain(torch.from_numpy(preds),
                                            torch.from_numpy(labels), k)
    assert torch.equal(got, want)
    assert confusion.KERNEL.launches == 0


def _dirichlet_inputs():
    """The seeded data of tests/test_pallas_kernels.py."""
    rng = np.random.RandomState(0)
    k = 14
    probs = [rng.dirichlet(np.ones(k), size=(2, 24, 16)).astype(np.float32)
             for _ in range(2)]
    alphas = [rng.rand(k, k) * 4 + 0.5 for _ in range(2)]
    prior = rng.dirichlet(np.ones(k))
    return probs, alphas, prior, 0.3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dirichlet_plain_matches_pallas(dtype):
    probs, alphas, prior, sigma = _dirichlet_inputs()
    jprobs = [jnp.asarray(p, dtype) for p in probs]
    want = np.asarray(dirichlet_kernel.dirichlet_fusion_label(
        jprobs, alphas, prior, sigma=sigma, tile=256, interpret=True))
    tprobs = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in probs]
    dirichlet.KERNEL.launches = 0
    got = dirichlet.dirichlet_fusion_label(tprobs, alphas, prior,
                                           sigma=sigma)
    assert dirichlet.KERNEL.launches == 0
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_dirichlet_plain_matches_xla_fusion():
    """The kernel's function is the argmax of the XLA fusion score."""
    probs, alphas, prior, sigma = _dirichlet_inputs()
    want = np.argmax(np.asarray(jfm.dirichlet_fusion(
        [jnp.asarray(p) for p in probs], alphas, prior, sigma=sigma)),
        axis=-1)
    got = dirichlet.dirichlet_fusion_label(
        [torch.from_numpy(p) for p in probs], alphas, prior, sigma=sigma)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions: a tensor elsewhere goes
    to the kernel or raises, it never falls back."""
    meta = torch.empty(2, 8, 14, device="meta")
    with pytest.raises(ValueError, match="device"):
        dirichlet.dirichlet_label(meta, meta, meta)
    labels = torch.empty(10, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        confusion.confusion_matrix(labels, labels, 4)
