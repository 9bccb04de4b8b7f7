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


@pytest.mark.parametrize("experts", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dirichlet_list_and_stacked_forms_agree(experts, dtype):
    """The expert-pointer form (a list of per-expert [P, K] tensors, which
    the kernel reads in place on the card) and the stacked [E, P, K] form
    give equal labels through the plain version on the CPU."""
    rng = np.random.RandomState(experts)
    k, pixels = 14, 777
    probs = [torch.from_numpy(rng.dirichlet(np.ones(k), size=pixels).astype(
        np.float32)).to(dtype) for _ in range(experts)]
    coeffs, bias = dirichlet.dirichlet_tables(
        [rng.rand(k, k) * 4 + 0.5 for _ in range(experts)],
        rng.dirichlet(np.ones(k)), 0.5, k)
    coeffs, bias = torch.from_numpy(coeffs), torch.from_numpy(bias)
    dirichlet.KERNEL.launches = 0
    listed = dirichlet.dirichlet_label(probs, coeffs, bias)
    stacked = dirichlet.dirichlet_label(torch.stack(probs), coeffs, bias)
    assert dirichlet.KERNEL.launches == 0
    assert listed.dtype == torch.int32 and tuple(listed.shape) == (pixels,)
    assert torch.equal(listed, stacked)
    assert torch.equal(listed, dirichlet.dirichlet_label_plain(
        torch.stack(probs), coeffs, bias))


def test_dirichlet_shared_memory_fits_the_flagship():
    """The kernel's block at the flagship (2 experts, 14 classes) holds
    the bfloat16 log table and a ring of three slabs within 227 KB; its
    coefficients go by value, K = 14 as one exact chunk of 14 classes, and
    at most 4 experts are taken."""
    assert dirichlet.class_chunk(14) == 14
    assert dirichlet.class_chunk(20) == 16
    assert dirichlet.class_chunk(3) == 4
    table = 4 * dirichlet.LOG_TABLE_SIZE
    assert dirichlet.smem_bytes(2, 14, 2) == table + 3 * 2 * 256 * 14 * 2
    assert dirichlet.smem_bytes(2, 14, 4) == 3 * 2 * 256 * 14 * 4
    for experts, k, value_bytes in ((4, 16, 2), (3, 20, 4)):
        assert dirichlet.smem_bytes(experts, k, value_bytes) <= 227 * 1024
    assert dirichlet.fits_by_value(4, 16, 16)
    assert dirichlet.fits_by_value(3, 20, 20)  # 2 chunks x 3 x 20 x 16
    assert not dirichlet.fits_by_value(4, 40, 40)
    assert dirichlet.MAX_EXPERTS == 4


def test_dirichlet_log_table_is_the_plain_log_by_bits():
    """Entry i of the bfloat16 log table is the plain version's log of the
    bfloat16 whose bits are i; the table covers every value in [0, 1]."""
    table = dirichlet.log_table("cpu")
    assert table.dtype == torch.float32
    assert table.shape == (dirichlet.LOG_TABLE_SIZE,)
    rng = np.random.RandomState(0)
    values = torch.from_numpy(np.concatenate([
        rng.dirichlet(np.ones(14), size=100).ravel(), [0.0, 1.0, 1e-30]])
        .astype(np.float32)).to(torch.bfloat16)
    bits = values.view(torch.int16).long()
    assert int(bits.max()) < dirichlet.LOG_TABLE_SIZE
    assert torch.equal(table[bits], torch.log(1e-20 + values.float()))
    one = torch.tensor([1.0], dtype=torch.bfloat16).view(torch.int16)
    assert int(one) < dirichlet.LOG_TABLE_SIZE
