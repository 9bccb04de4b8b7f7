"""The port's eval layers against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and fed to both. All
comparisons are float32 with atol 1e-5 (the sums run in another order in
the two frameworks; the values here are of order 1).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.ops import layers as jll
from modular_semantic_segmentation_tpu.ops import fast_upsample as jfu
from modular_semantic_segmentation_tpu.ops import init as jinit
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_torch.ops import layers as tll
from modular_semantic_segmentation_torch.ops import fast_upsample as tfu
from modular_semantic_segmentation_torch.ops import init as tinit
from modular_semantic_segmentation_torch.ops.variables import (
    Ctx, resolve_device)

ATOL = 1e-5


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


def _contexts(variables):
    jctx = JCtx({k: jnp.asarray(v) for k, v in variables.items()},
                train=False)
    tctx = Ctx({k: torch.from_numpy(v) for k, v in variables.items()})
    return jctx, tctx


def _bn_variables(rng, name, dim):
    return {f"{name}/gamma": rng.rand(dim).astype(np.float32) + 0.5,
            f"{name}/beta": rng.randn(dim).astype(np.float32),
            f"{name}/moving_mean": rng.randn(dim).astype(np.float32),
            f"{name}/moving_variance": rng.rand(dim).astype(np.float32)
            + 0.1}


def _close(jax_out, torch_out):
    got = torch_out.detach().numpy()
    want = np.asarray(jax_out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,kernel,stride,dilation,bn", [
    ((2, 9, 11, 5), 3, 1, 1, False),
    ((1, 9, 11, 5), 3, 2, 1, True),    # odd size: asymmetric SAME
    ((1, 10, 12, 6), 4, 2, 1, False),  # even kernel at stride 2
    ((1, 12, 10, 4), 3, 1, 2, True),   # dilation
    ((1, 16, 12, 3), 3, 1, 1, False),  # thin input (the JAX im2col path)
    ((1, 8, 6, 7), 1, 1, 1, True),     # 1x1
])
def test_conv2d_matches_jax(shape, kernel, stride, dilation, bn):
    rng = np.random.RandomState(0)
    cin, cout = shape[-1], 8
    x = rng.randn(*shape).astype(np.float32)
    variables = {
        "c/kernel": (rng.randn(kernel, kernel, cin, cout) * 0.3).astype(
            np.float32),
        "c/bias": rng.randn(cout).astype(np.float32)}
    if bn:
        variables.update(_bn_variables(rng, "c", cout))
    jctx, tctx = _contexts(variables)
    want = jll.conv2d(jctx, jnp.asarray(x), cout, kernel, "c",
                      strides=stride, dilation_rate=dilation,
                      batch_normalization=bn)
    got = tll.conv2d(tctx, torch.from_numpy(x), cout, kernel, "c",
                     strides=stride, dilation_rate=dilation,
                     batch_normalization=bn)
    _close(want, got)


def test_batch_norm_eval_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 6).astype(np.float32) * 3
    jctx, tctx = _contexts(_bn_variables(rng, "bn", 6))
    _close(jll.batch_norm(jctx, jnp.asarray(x), "bn"),
           tll.batch_norm(tctx, torch.from_numpy(x), "bn"))


def test_max_pool2d_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 8, 3).astype(np.float32)  # odd height: VALID drops
    jctx, tctx = _contexts({})
    _close(jll.max_pool2d(jctx, jnp.asarray(x), 2, 2),
           tll.max_pool2d(tctx, torch.from_numpy(x), 2, 2))


@pytest.mark.parametrize("kernel,stride", [(4, 2), (16, 8)])
def test_bilinear_deconv_matches_jax(kernel, stride):
    """The frozen channel-diagonal deconvs of SimpleFCN (4x4/s2 and
    16x16/s8) with BN and ReLU, through both packages' fast paths."""
    rng = np.random.RandomState(3)
    c = 5
    x = rng.randn(1, 6, 4, c).astype(np.float32)
    variables = {"d/kernel": jinit.bilinear_filter((kernel, kernel, c, c))}
    variables.update(_bn_variables(rng, "d", c))
    jctx, tctx = _contexts(variables)
    want = jll.deconv2d(jctx, jnp.asarray(x), c, kernel, "d",
                        strides=stride, activation=jnp.tanh)
    got = tll.deconv2d(tctx, torch.from_numpy(x), c, kernel, "d",
                       strides=stride, activation=torch.tanh)
    _close(want, got)


@pytest.mark.parametrize("kernel,stride,cout", [(4, 2, 3), (3, 2, 4),
                                                (5, 1, 6)])
def test_dense_deconv_matches_jax(kernel, stride, cout):
    """A non-diagonal kernel takes the dense conv_transpose2d fallback."""
    rng = np.random.RandomState(4)
    cin = 4
    x = rng.randn(2, 5, 7, cin).astype(np.float32)
    variables = {"d/kernel": (rng.randn(kernel, kernel, cout, cin)
                              * 0.3).astype(np.float32)}
    jctx, tctx = _contexts(variables)
    want = jll.deconv2d(jctx, jnp.asarray(x), cout, kernel, "d",
                        strides=stride, batch_normalization=False)
    got = tll.deconv2d(tctx, torch.from_numpy(x), cout, kernel, "d",
                       strides=stride, batch_normalization=False)
    _close(want, got)


def test_diagonal_upsample_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    diag = rng.randn(16, 16, 4).astype(np.float32)
    _close(jfu.diagonal_upsample(jnp.asarray(x), jnp.asarray(diag), 8),
           tfu.diagonal_upsample(torch.from_numpy(x),
                                 torch.from_numpy(diag), 8))


def test_softmax_and_log_softmax_match_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 4, 5, 14) * 10).astype(np.float32)
    _close(jll.softmax(jnp.asarray(x)), tll.softmax(torch.from_numpy(x)))
    _close(jll.log_softmax(jnp.asarray(x)),
           tll.log_softmax(torch.from_numpy(x)))


def test_initializers_match_jax():
    """The bilinear kernel is the JAX package's exactly; the seeded
    Glorot draw stays inside the Glorot limit."""
    shape = (16, 16, 3, 3)
    np.testing.assert_array_equal(tinit.bilinear_filter(shape),
                                  jinit.bilinear_filter(shape))
    w = tinit.glorot_uniform(np.random.RandomState(0), (3, 3, 8, 16))
    limit = np.sqrt(6.0 / (9 * 8 + 9 * 16))
    assert w.dtype == np.float32 and np.abs(w).max() <= limit
    store = tinit.build_variables([("a/kernel", (3, 3, 8, 16),
                                    tinit.glorot_uniform)], seed=0)
    np.testing.assert_array_equal(store["a/kernel"].numpy(), w)


@pytest.mark.parametrize("shape,pool", [((2, 8, 8, 3), 2),
                                        ((1, 9, 12, 5), 3)])
def test_max_pool_with_argmax_and_unpool_match_jax(shape, pool):
    """Exact on tie-free input: the pooled values, TF's flattened [H*W*C]
    indices and the unpooled tensor."""
    rng = np.random.RandomState(3)
    x = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.float32)
    jpooled, jidx = jll.max_pool_with_argmax(jnp.asarray(x), pool, pool)
    pooled, idx = tll.max_pool_with_argmax(torch.from_numpy(x), pool, pool)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jpooled))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if pool == 2:
        np.testing.assert_array_equal(
            tll.unpool_2d(pooled, idx).numpy(),
            np.asarray(jll.unpool_2d(jpooled, jidx)))


def test_ops_exports_the_jax_names():
    import modular_semantic_segmentation_tpu.ops as jops
    import modular_semantic_segmentation_torch.ops as tops
    assert set(jops.__all__) - set(tops.__all__) == {"init_variables"}
    assert tops.unpool_2d is tll.unpool_2d


def test_cuda_device_raises_without_a_card():
    """device='cuda' on a host without a card raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
