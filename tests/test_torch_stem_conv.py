"""The port's plain stem conv (``ops/cuda/stem_conv.py``) against the JAX
probe's Pallas kernel (``scripts/pallas_stem_conv_probe.py``, interpret
mode) and against ``F.conv2d``, on the CPU.

Tolerances: against the probe ``max|port - jax| <= 1e-2 * max|jax|``, as
the probe holds its kernel against XLA's conv (both round the output to
bfloat16 and sum 9*Cin products in another order); against ``F.conv2d``
in float32 on bfloat16-exact inputs, before the final cast, 1e-5 of the
largest value.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from modular_semantic_segmentation_torch.ops.cuda import stem_conv

PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "pallas_stem_conv_probe.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def probe():
    """The probe module, loaded by path in interpret mode (it reads
    MSSTPU_INTERPRET when imported)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSSTPU_INTERPRET", "1")
        spec = importlib.util.spec_from_file_location(
            "pallas_stem_conv_probe", PROBE)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    assert module.INTERPRET
    return module


@pytest.mark.parametrize("height,width,cin,cout", [(16, 48, 8, 16),
                                                   (16, 384, 64, 64)])
def test_plain_matches_jax_probe(probe, height, width, cin, cout):
    x, kernel, bias = stem_conv.probe_inputs(height, width, cin, cout,
                                             seed=0)
    want = np.asarray(probe.pallas_conv_nhwc(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)),
        np.float32)
    got = stem_conv.stem_conv_nhwc(torch.from_numpy(x),
                                   torch.from_numpy(kernel),
                                   torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert got.shape == (1, height, width, cout)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * scale


def test_plain_matches_conv2d_at_a_ragged_shape():
    """[2, 13, 7, 24] -> 40: odd sizes, SAME zero padding at every edge."""
    rng = np.random.RandomState(3)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    x = to_bf16(rng.randn(2, 13, 7, 24).astype(np.float32))
    kernel = to_bf16(rng.randn(3, 3, 24, 40).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.randn(40).astype(np.float32) * 0.1)
    got = stem_conv.stem_conv_nhwc(x, kernel, bias)
    want = torch.relu(F.conv2d(x.float().permute(0, 3, 1, 2),
                               kernel.float().permute(3, 2, 0, 1), bias,
                               padding=1)).permute(0, 2, 3, 1)
    assert float((got.float() - want).abs().max()) <= 1e-2 * float(
        want.abs().max())


def test_plain_matches_conv2d_in_float32_before_the_cast():
    """The plain arithmetic itself, before bias and the bfloat16 cast:
    ``conv3x3_f32`` equals a float32 conv on the same bfloat16-exact
    values."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 9, 11, 16).astype(np.float32)).to(
        torch.bfloat16)
    kernel = torch.from_numpy(rng.randn(3, 3, 16, 8).astype(
        np.float32)).to(torch.bfloat16)
    mine = stem_conv.conv3x3_f32(x, kernel)
    assert mine.dtype == torch.float32 and mine.shape == (1, 9, 11, 8)
    want = F.conv2d(x.float().permute(0, 3, 1, 2),
                    kernel.float().permute(3, 2, 0, 1), padding=1)
    want = want.permute(0, 2, 3, 1)
    assert float((mine - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_wrapper_takes_plain_version_on_cpu():
    x, kernel, bias = stem_conv.probe_inputs(8, 8, 16, 8, seed=1)
    args = [torch.from_numpy(a) for a in (x, kernel, bias)]
    stem_conv.KERNEL.launches = 0
    got = stem_conv.stem_conv_nhwc(*args)
    assert stem_conv.KERNEL.launches == 0
    assert torch.equal(got, stem_conv.stem_conv_nhwc_plain(*args))


def test_probe_on_cpu_checks_without_timings():
    out = stem_conv.probe(height=8, width=24, cin=16, cout=8, device="cpu")
    assert out["max_abs_err"] == 0.0 and out["scale"] > 0
    assert "ms" not in out
    assert stem_conv.bound_bytes_and_flops(1, 768, 384, 64, 64) == (
        75571456, 2.0 * 9 * 64 * 64 * 768 * 384)


class _FakeCuda:
    """Stands in for a CUDA tensor in the wrapper's checks, which raise
    before anything touches the card."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device("cuda")

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("cin,cout,match", [(8, 16, "multiple of 16"),
                                            (3, 64, "multiple of 16"),
                                            (16, 12, "multiple of 8"),
                                            (24, 64, "multiple of 16")])
def test_wrapper_raises_on_unsupported_channels(cin, cout, match):
    with pytest.raises(ValueError, match=match):
        stem_conv.stem_conv_nhwc(_FakeCuda(1, 8, 8, cin),
                                 _FakeCuda(3, 3, cin, cout),
                                 _FakeCuda(cout))


@pytest.mark.parametrize("cin", range(16, 129, 16))
def test_packed_weights_are_a_permutation_of_the_weight_matrix(cin):
    """``pack_weights`` moves every entry of the [9*Cin, Cout] matrix to
    the place the kernel's wgmma reads it from, pads Cout with zeros to a
    multiple of 64, and ``unpack_weights`` undoes it exactly."""
    rng = np.random.RandomState(cin)
    for cout in range(8, 129, 8):
        kernel = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(
            np.float32)).to(torch.bfloat16)
        wmat = kernel.reshape(9 * cin, cout)
        packed = stem_conv.pack_weights(kernel)
        chunks = -(-cout // 64)
        assert packed.shape == (chunks, 9 * cin // 16, 8, 2, 8, 8)
        assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
        assert torch.equal(stem_conv.unpack_weights(packed, cin, cout), wmat)
        # element [j, s, g, h, r, c] is wmat[16 s + 8 h + c, 64 j + 8 g + r]
        j, s, g, h, r, c = (rng.randint(0, n, 50) for n in packed.shape)
        co = 64 * j + 8 * g + r
        inside = co < cout
        got = packed[j, s, g, h, r, c].float().numpy()
        want = wmat.float().numpy()[16 * s + 8 * h + c, np.minimum(
            co, cout - 1)]
        np.testing.assert_array_equal(got[inside], want[inside])
        assert not got[~inside].any()
        # a permutation: the same multiset of values, plus the zero padding
        values = np.sort(packed.float().numpy().ravel())
        padding = np.zeros(packed.numel() - wmat.numel(), np.float32)
        np.testing.assert_array_equal(values, np.sort(np.concatenate(
            [wmat.float().numpy().ravel(), padding])))


@pytest.mark.parametrize("cin", range(16, 129, 16))
def test_tile_config_fits_shared_memory(cin):
    """For every Cin the kernel takes, the chosen ring stage holds a
    multiple of 16 channels that divides Cin, and the block (weights of 64
    output channels, staged output, two patch stages) fits 227 KB."""
    config = stem_conv.tile_config(cin)
    cg = config["cg"]
    assert cg % 16 == 0 and cin % cg == 0
    assert config["smem"] == stem_conv.smem_bytes(cin, cg)
    assert config["smem"] <= 227 * 1024
    plane = (6 * 66 + 1) * 16
    assert config["smem"] == (9 * cin * 64 * 2 + 2 * 64 * 72 * 2
                              + 2 * (cg // 8) * plane)
    # no wider stage that divides Cin would fit
    for wider in range(cg + 16, cin + 1, 16):
        if cin % wider == 0:
            assert stem_conv.smem_bytes(cin, wider) > 227 * 1024
    if cin == 64:  # conv1_2 and conv2_1: one stage holds all channels
        assert cg == 64
