"""The frozen channel-diagonal upsample's host side, on the CPU: the tap
table that ``ops/cuda/upsample.py`` hands ``csrc/upsample.cu``, the plain
twins that gather from it (the forward and its adjoint) against
``F.conv_transpose2d`` with the SAME crop and its autograd, the registered
operators (autograd, the profiler's counters, ``torch.export``), the
vector width the wrapper picks and the refusal of a kernel that requires a
gradient. The kernels themselves are held against the twins on the card
(``tests/test_torch_gpu.py``, marked ``gpu``).

Sums are compared in float64 against float32 twins, within 1e-5 of the
largest value (the values are of order 1, sums of at most 25 terms).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch.profiler import ProfilerActivity, profile

from modular_semantic_segmentation_torch.ops import fast_upsample
from modular_semantic_segmentation_torch.ops.cuda import upsample
from modular_semantic_segmentation_torch.utils import tracing

KERNELS = [(4, 2), (16, 8), (3, 2), (5, 2)]
SHAPES = [(2, 3, 5), (1, 7, 3)]
CHANNELS = [1, 14, 64]
RTOL = 1e-5


def _reference(x, diag, s):
    """TF conv2d_transpose with SAME padding and the dense diagonal kernel:
    PyTorch's grouped transposed conv, cropped."""
    k = diag.shape[0]
    n, h, w, c = x.shape
    lo = upsample.same_transpose_crop(k, s)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                             diag.permute(2, 0, 1).unsqueeze(1), stride=s,
                             groups=c)
    return out[:, :, lo:lo + h * s, lo:lo + w * s].permute(0, 2, 3, 1)


def _inputs(k, s, shape, c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, c, generator=gen, dtype=torch.float64)
    diag = torch.randn(k, k, c, generator=gen, dtype=torch.float64)
    return x, diag


def _assert_close(got, want):
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("k,s", KERNELS + [(2, 2), (7, 3), (9, 2)])
def test_tap_table_lists_every_tap_of_the_transposed_conv(k, s):
    """Every (output row, input row, kernel row) triple of the cropped
    transposed conv (o + lo = i * s + a, 0 <= a < k) is one valid tap of
    the phase of o, and every valid tap is one such triple."""
    lo = upsample.same_transpose_crop(k, s)
    offsets, indices, valid = upsample.phase_taps(k, s)
    assert offsets.shape == indices.shape == (s, -(-k // s))
    h = 5
    for o in range(h * s):
        q, p = divmod(o, s)
        want = {(i, o + lo - i * s) for i in range(-k, h + k)
                if 0 <= o + lo - i * s < k}
        got = {(q + d, a) for d, a, ok in zip(offsets[p], indices[p],
                                              valid[p]) if ok}
        assert got == want, (o, got, want)


@pytest.mark.parametrize("k,s", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_plain_twin_matches_the_grouped_transposed_conv(k, s, shape, c):
    x, diag = _inputs(k, s, shape, c)
    got = upsample.diagonal_upsample_plain(x.float(), diag.float(), s)
    assert got.dtype == torch.float32
    _assert_close(got, _reference(x, diag, s))


@pytest.mark.parametrize("k,s", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_plain_adjoint_is_the_input_gradient(k, s, shape, c):
    """The adjoint twin against autograd through the grouped transposed
    conv, and the operator's autograd (its registered backward) against
    both."""
    x, diag = _inputs(k, s, shape, c, seed=1)
    x.requires_grad_()
    out = _reference(x, diag, s)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    (want,) = torch.autograd.grad((out * g).sum(), x)
    got = upsample.diagonal_upsample_adjoint_plain(g.float(), diag.float(),
                                                   s)
    _assert_close(got, want)
    xf = x.detach().float().requires_grad_()
    served = fast_upsample.diagonal_upsample(xf, diag.float(), s)
    (via_op,) = torch.autograd.grad((served * g.float()).sum(), xf)
    _assert_close(via_op, want)


def test_bfloat16_rounds_the_float32_gather_once():
    """bfloat16 in and out: the float32 gather of the bf16 values, rounded
    once; the kernels are rounded to bf16 first."""
    x, diag = _inputs(16, 8, (1, 3, 5), 14)
    xb, db = x.to(torch.bfloat16), diag.to(torch.float32)
    got = fast_upsample.diagonal_upsample(xb, db, 8)
    assert got.dtype == torch.bfloat16
    want = upsample.diagonal_upsample_plain(
        xb.float(), db.to(torch.bfloat16).float(), 8).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_float64_sums_in_float64():
    """float64 in and out, summed in float64: within 1e-12 of the grouped
    transposed conv, forward and adjoint."""
    x, diag = _inputs(16, 8, (2, 3, 5), 6)
    got = upsample.diagonal_upsample_plain(x, diag, 8)
    want = _reference(x, diag, 8)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    g = torch.randn(want.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    xr = x.clone().requires_grad_()
    (want_adj,) = torch.autograd.grad((_reference(xr, diag, 8) * g).sum(),
                                      xr)
    got_adj = upsample.diagonal_upsample_adjoint_plain(g, diag, 8)
    assert float((got_adj - want_adj).abs().max()) <= 1e-12 * float(
        want_adj.abs().max())


def test_kernel_weights_that_require_a_gradient_raise():
    x, diag = _inputs(4, 2, (1, 3, 3), 4)
    with pytest.raises(ValueError, match="no gradient for the kernel"):
        fast_upsample.diagonal_upsample(x.float(),
                                        diag.float().requires_grad_(), 2)


@pytest.mark.parametrize("bad", ["stride", "shape"])
def test_unsupported_arguments_raise(bad):
    x, diag = _inputs(4, 2, (1, 3, 3), 4)
    x, diag = x.float(), diag.float()
    with pytest.raises(ValueError):
        if bad == "stride":
            fast_upsample.diagonal_upsample(x, diag, 5)
        else:
            fast_upsample.diagonal_upsample(x, diag[:, :, :3], 2)


def test_operators_count_while_a_profiler_records():
    """One ``upsample.forward`` per call and one ``upsample.adjoint`` per
    backward, only while a profiler records."""
    x, diag = _inputs(4, 2, (1, 3, 3), 4)
    x = x.float().requires_grad_()
    tracing.reset()
    fast_upsample.diagonal_upsample(x, diag.float(), 2).sum().backward()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            fast_upsample.diagonal_upsample(x, diag.float(), 2).sum(
            ).backward()
    counters = tracing.snapshot()["counters"]
    assert counters["upsample.forward"] == 2
    assert counters["upsample.adjoint"] == 2


def test_export_records_the_operator():
    """``torch.export`` keeps the operator as one node of the program, with
    the fake implementation's shape."""
    class Up(torch.nn.Module):
        def forward(self, x, diag):
            return fast_upsample.diagonal_upsample(x, diag, 8)

    x, diag = _inputs(16, 8, (1, 3, 5), 4)
    x, diag = x.float(), diag.float()
    program = torch.export.export(Up(), (x, diag))
    targets = [str(node.target) for node in program.graph.nodes]
    assert "msstorch.diagonal_upsample.default" in targets
    _assert_close(program.module()(x, diag),
                  upsample.diagonal_upsample_plain(x, diag, 8).double())


@pytest.mark.parametrize("c,itemsize,offset,want", [
    (64, 2, 0, 8), (64, 4, 0, 4), (14, 2, 0, 2), (1, 2, 0, 1), (24, 2, 0, 8),
    (64, 2, 2, 1), (64, 2, 4, 2), (64, 4, 8, 2), (6, 4, 0, 2)])
def test_vector_width(c, itemsize, offset, want):
    """The widest vector of at most 16 bytes that divides C and to which
    both pointers are aligned."""
    assert upsample.vector_width(c, itemsize, 256 + offset, 512) == want
