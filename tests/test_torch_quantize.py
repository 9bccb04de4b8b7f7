"""The port's int8 post-training quantization against the JAX package's,
on the CPU: the int8 branch and the calibration record of ``conv2d``, the
percentile, ``select_scales``, the int8 product and the family defaults.

Inputs and weights are made with numpy from a seed and fed to both.
Tolerances:
  * the int32 sums of identical int8 operands are exact;
  * the float32 int8 conv output within rtol 1e-5, except where an input
    lands within 1e-6 of a rounding midpoint of ``x / ascale`` (the two
    frameworks may round it to different sides); there the output may
    move by one input step (``ascale * max|kernel|``), on at most 0.1% of
    the elements;
  * calibrated amaxes at rtol 1e-5, scales at rtol 1e-6 (both are the
    same float32 maxima, carried as Python floats).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.models import quantize as jq
from modular_semantic_segmentation_tpu.models import packed_experts as jpe
from modular_semantic_segmentation_tpu.ops import layers as jll
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models import quantize as tq
from modular_semantic_segmentation_torch.models import packed_experts as tpe
from modular_semantic_segmentation_torch.ops import int8_conv
from modular_semantic_segmentation_torch.ops import layers as tll
from modular_semantic_segmentation_torch.ops.variables import Ctx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_layers.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONVS = [
    # (input shape, kernel, stride, dilation, output channels)
    ((2, 9, 11, 24), 3, 1, 1, 16),     # 3x3
    ((1, 8, 6, 32), 1, 1, 1, 16),      # 1x1
    ((1, 9, 11, 16), 3, 2, 1, 8),      # stride 2, odd size: asymmetric SAME
    ((1, 12, 10, 16), 3, 1, 2, 8),     # dilation 2
]


def _conv_case(shape, kernel, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    variables = {
        "c/kernel": (rng.randn(kernel, kernel, shape[-1], cout)
                     * 0.3).astype(np.float32),
        "c/bias": rng.randn(cout).astype(np.float32)}
    ascale = float(np.abs(x).max()) / 127.0
    return x, variables, {"c/input_amax": ascale}


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_conv(x, variables, scales, kernel, stride, dilation, cout,
              dtype="float32"):
    ctx = JCtx({k: jnp.asarray(v) for k, v in variables.items()},
               act_scales=scales, compute_dtype=DTYPES[dtype][0])
    out = jll.conv2d(ctx, jnp.asarray(x), cout, kernel, "c", strides=stride,
                     dilation_rate=dilation, activation=None)
    return np.asarray(out.astype(jnp.float32))


def _torch_conv(x, variables, scales, kernel, stride, dilation, cout,
                dtype="float32"):
    ctx = Ctx({k: torch.from_numpy(v) for k, v in variables.items()},
              act_scales=scales, compute_dtype=DTYPES[dtype][1])
    out = tll.conv2d(ctx, torch.from_numpy(x), cout, kernel, "c",
                     strides=stride, dilation_rate=dilation, activation=None)
    assert out.dtype == DTYPES[dtype][1]
    return out.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,kernel,stride,dilation,cout", CONVS)
def test_int8_conv2d_matches_jax(shape, kernel, stride, dilation, cout,
                                 dtype):
    """The int8 branch in both compute dtypes: its float32 output, or that
    output rounded to bfloat16 after the bias, as JAX's (run op by op)."""
    x, variables, scales = _conv_case(shape, kernel, cout)
    args = (kernel, stride, dilation, cout, dtype)
    want = _jax_conv(x, variables, scales, *args)
    got = _torch_conv(x, variables, scales, *args)
    assert got.shape == want.shape
    # the int8 branch ran: the float conv gives something else
    floated = _jax_conv(x, variables, None, *args)
    assert np.abs(floated - want).max() > 0
    ascale = scales["c/input_amax"]
    ratio = x.astype(np.float64) / np.float64(np.float32(ascale))
    at_midpoint = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-6
    differ = ~np.isclose(got, want, rtol=1e-5, atol=0)
    if not at_midpoint.any():
        assert not differ.any()
    step = ascale * np.abs(variables["c/kernel"]).max()
    assert differ.mean() <= 1e-3
    assert np.all(np.abs(got - want)[differ] <= step * (1 + 1e-5))


@pytest.mark.parametrize("shape,kernel,stride,dilation,cout", CONVS)
def test_int8_accumulator_exact_on_jax_operands(shape, kernel, stride,
                                                dilation, cout):
    """JAX's own int8 operands through the port's im2col product: the
    int32 sums equal ``lax.conv_general_dilated``'s bit for bit."""
    x, variables, scales = _conv_case(shape, kernel, cout)
    k = jnp.asarray(variables["c/kernel"])
    kscale = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-12) / 127.0
    kq = jnp.clip(jnp.round(k / kscale), -127, 127).astype(jnp.int8)
    xq = jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(
        scales["c/input_amax"])), -127, 127).astype(jnp.int8)
    want = jax.lax.conv_general_dilated(
        xq, kq, (stride, stride), "SAME", rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    n, h, w, _ = shape
    pads = (tll._same_pads(h, kernel, stride, dilation),
            tll._same_pads(w, kernel, stride, dilation))
    kq_t = torch.from_numpy(np.array(kq)).reshape(-1, cout).t()
    got = int8_conv.int8_conv2d(
        torch.from_numpy(np.array(xq)), kq_t.contiguous(),
        (kernel, kernel), (stride, stride), (dilation, dilation), pads)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the port quantizes the kernel to the same int8 values and scales
    tkq, tks = int8_conv.quantize_kernel(
        torch.from_numpy(variables["c/kernel"]))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(kscale))


def _reentrant_net(layers, ctx, xs):
    """One conv scope entered once per input, then a second conv."""
    outs = [layers.conv2d(ctx, x, 4, 3, "shared", activation=None)
            for x in xs]
    return layers.conv2d(ctx, outs[0], 4, 1, "second", activation=None)


def _calibration_case(seed=1):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(1, 6, 5, 8) * s).astype(np.float32) for s in (1, 7, 2)]
    variables = {
        "shared/kernel": rng.randn(3, 3, 8, 4).astype(np.float32),
        "shared/bias": rng.randn(4).astype(np.float32),
        "second/kernel": rng.randn(1, 1, 4, 4).astype(np.float32),
        "second/bias": rng.randn(4).astype(np.float32)}
    return xs, variables


@pytest.mark.parametrize("percentile", [100.0, 99.0])
def test_calibration_amax_matches_jax(percentile):
    xs, variables = _calibration_case()
    jctx = JCtx({k: jnp.asarray(v) for k, v in variables.items()},
                calibrate=True, calibrate_percentile=percentile)
    _reentrant_net(jll, jctx, [jnp.asarray(x) for x in xs])
    tctx = Ctx({k: torch.from_numpy(v) for k, v in variables.items()},
               calibrate=True, calibrate_percentile=percentile)
    _reentrant_net(tll, tctx, [torch.from_numpy(x) for x in xs])
    assert set(tctx.amax) == set(jctx.amax) == {
        "shared/input_amax", "shared/input_pixels", "second/input_amax",
        "second/input_pixels"}
    for key, value in jctx.amax.items():
        np.testing.assert_allclose(float(tctx.amax[key]), float(value),
                                   rtol=1e-5)
    # the running max over the re-entered scope is the largest input's
    want = max(np.percentile(np.abs(x), percentile) for x in xs)
    np.testing.assert_allclose(float(tctx.amax["shared/input_amax"]), want,
                               rtol=1e-5)
    assert float(tctx.amax["shared/input_pixels"]) == 30.0


def test_percentile_above_quantile_limit_matches_numpy():
    """torch.quantile refuses more than 2**24 elements; conv1_2's input at
    768x384x64 has 18.9 M."""
    rng = np.random.RandomState(2)
    x = np.abs(rng.randn(2 ** 24 + 4099).astype(np.float32))
    got = tll.percentile(torch.from_numpy(x), 99.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(np.percentile(x, 99.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("q", [0.0, 37.5, 99.0, 99.9, 100.0])
def test_percentile_matches_numpy_small(q):
    x = np.abs(np.random.RandomState(3).randn(1, 7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tll.percentile(torch.from_numpy(x), q)),
                               float(np.percentile(x, q)), rtol=1e-6)


def _stem_variables(depth_in=1):
    return {"rgb/conv1_1/kernel": (3, 3, 3, 64),
            "depth/conv1_1/kernel": (3, 3, depth_in, 64),
            "rgb/conv1_2/kernel": (3, 3, 64, 64),
            "depth/conv1_2/kernel": (3, 3, 64, 64),
            "rgb/conv2_1/kernel": (3, 3, 64, 128),
            "depth/conv2_1/kernel": (3, 3, 64, 128)}


_STEM_AMAX = {"rgb/conv1_2/input_amax": 4.0, "depth/conv1_2/input_amax": 0.5,
              "rgb/conv2_1/input_amax": 2.0,
              "depth/conv2_1/input_amax": 0.25}

# the JAX package's eligibility cases (tests/test_quantized_serving.py):
# (kernel shapes, amax, select_scales keyword arguments)
SELECT_CASES = {
    "channels": (
        {"rgb/conv1_1/kernel": (3, 3, 3, 64),
         "rgb/conv4_1/kernel": (3, 3, 256, 512),
         "rgb/score/kernel": (1, 1, 512, 14)},
        {"rgb/conv1_1/input_amax": 2.0, "rgb/conv4_1/input_amax": 8.0,
         "rgb/score/input_amax": 4.0, "rgb/nosuchconv/input_amax": 1.0},
        {"min_channels": 128}),
    "pixels": (
        {"rgb/conv1_1/kernel": (3, 3, 3, 64),
         "rgb/conv4_1/kernel": (3, 3, 256, 512),
         "rgb/score/kernel": (1, 1, 512, 14)},
        {"rgb/conv1_1/input_amax": 2.0, "rgb/conv4_1/input_amax": 8.0,
         "rgb/score/input_amax": 4.0, "rgb/nosuchconv/input_amax": 1.0,
         "rgb/conv4_1/input_pixels": 48.0 * 24,
         "rgb/score/input_pixels": 96.0 * 48},
        {"min_channels": 128, "min_pixels": 2048}),
    "stems unpacked": (_stem_variables(), dict(_STEM_AMAX),
                       {"min_channels": 128}),
    "stems packed": (_stem_variables(), dict(_STEM_AMAX),
                     {"min_channels": 128,
                      "packed_stem_prefixes": ("rgb", "depth")}),
    "packed all-or-none": (
        _stem_variables(),
        {k: v for k, v in _STEM_AMAX.items()
         if k != "depth/conv2_1/input_amax"},
        {"min_channels": 128, "packed_stem_prefixes": ("rgb", "depth")}),
    "packed wide input": (
        _stem_variables(depth_in=8), dict(_STEM_AMAX),
        {"min_channels": 128, "packed_stem_prefixes": ("rgb", "depth")}),
    "packed grid mismatch": (
        _stem_variables(),
        dict(_STEM_AMAX, **{"rgb/conv1_1/input_pixels": 768.0 * 384,
                            "depth/conv1_1/input_pixels": 384.0 * 192}),
        {"min_channels": 128, "packed_stem_prefixes": ("rgb", "depth")}),
    "packed low floor": (
        _stem_variables(),
        dict(_STEM_AMAX, **{"rgb/conv1_1/input_amax": 255.0,
                            "depth/conv1_1/input_amax": 10.0}),
        {"min_channels": 1, "packed_stem_prefixes": ("rgb", "depth")}),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_scales_matches_jax(case):
    shapes, amax, kwargs = SELECT_CASES[case]
    want = jq.select_scales(dict(amax), {k: jnp.zeros(s)
                                         for k, s in shapes.items()},
                            **kwargs)
    got = tq.select_scales(dict(amax), {k: torch.zeros(s)
                                        for k, s in shapes.items()},
                           **kwargs)
    assert set(got) == set(want)
    for key, value in want.items():
        assert isinstance(got[key], float)
        np.testing.assert_allclose(got[key], value, rtol=1e-6)
    if case == "stems packed":
        assert set(got) == {"packed:" + k for k in _STEM_AMAX}


@pytest.mark.parametrize("m,k,n", [(37, 72, 16), (5, 9, 3), (300, 4608, 64)])
def test_int8_plain_product_is_exact(m, k, n):
    rng = np.random.RandomState(m)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (n, k)).astype(np.int8)
    a[0, :] = 127
    b[0, :] = -127  # the largest sum in magnitude
    got = int8_conv.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("shape,kernel,stride,dilation,cout", CONVS + [
    ((1, 7, 9, 3), 3, 1, 1, 8),    # im2col copies single bytes
    ((1, 7, 9, 6), 3, 2, 1, 8),    # 2-byte words
    ((1, 7, 9, 12), 3, 1, 2, 8)])  # 4-byte words
def test_int8_conv_equals_float64_conv(shape, kernel, stride, dilation,
                                       cout):
    """The im2col product against a float64 convolution of the same int8
    values (exact: the sums are integers far below 2**53), for each word
    size im2col copies in."""
    rng = np.random.RandomState(4)
    xq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    kq = torch.from_numpy(rng.randint(
        -127, 128, (kernel, kernel, shape[-1], cout)).astype(np.int8))
    n, h, w, _ = shape
    ph = tll._same_pads(h, kernel, stride, dilation)
    pw = tll._same_pads(w, kernel, stride, dilation)
    got = int8_conv.int8_conv2d(xq, kq.reshape(-1, cout).t().contiguous(),
                                (kernel, kernel), (stride, stride),
                                (dilation, dilation), (ph, pw))
    padded = torch.nn.functional.pad(xq.double(), (0, 0, *pw, *ph))
    want = torch.nn.functional.conv2d(
        padded.permute(0, 3, 1, 2), kq.double().permute(3, 2, 0, 1),
        stride=stride, dilation=dilation).permute(0, 2, 3, 1)
    assert torch.equal(got.long(), want.long())
    assert torch.equal(want, want.round())


DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, 4)


def test_ptq_family_defaults_match_jax():
    from modular_semantic_segmentation_tpu.models.estimator import \
        Estimator as JEstimator
    from modular_semantic_segmentation_torch.models.estimator import \
        Estimator
    assert Estimator.ptq_min_pixels == JEstimator.ptq_min_pixels == 2048
    assert Estimator.packs_expert_stems is JEstimator.packs_expert_stems
    for name in ("simple_fcn", "bayesian_fcn"):
        assert (get_model(name).ptq_min_pixels
                == jax_model(name).ptq_min_pixels == 0)
    for name in ("bayes_mix", "dirichlet_mix", "average", "variance",
                 "uncertainty_dirichlet_mix"):
        assert (get_model(name).packs_expert_stems
                is jax_model(name).packs_expert_stems)
    cms = {m: np.eye(4) + 1 for m in ("rgb", "depth")}
    net = get_model("bayes_mix")(
        data_description=DATA_DESCRIPTION, confusion_matrices=cms,
        num_units=2, channel_factor=0.0625, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"}, device="cpu")
    assert net.ptq_min_pixels == 0
    net.config["expert_model"] = "adapnet"
    assert net.ptq_min_pixels == 2048


def _batch(shapes):
    return {m: np.zeros(s, np.float32) for m, s in shapes.items()}


PACK_CASES = [
    # (config, batch shapes, calibrating)
    ({}, {"rgb": (1, 8, 8, 3), "depth": (1, 8, 8, 1)}, False),
    ({}, {"rgb": (1, 8, 8, 3), "depth": (1, 8, 8, 1)}, True),
    ({"pack_experts": False}, {"rgb": (1, 8, 8, 3), "depth": (1, 8, 8, 1)},
     False),
    ({"expert_model": "adapnet"},
     {"rgb": (1, 8, 8, 3), "depth": (1, 8, 8, 1)}, False),
    ({}, {"rgb": (1, 8, 8, 3)}, False),
    ({}, {"rgb": (1, 8, 8, 3), "depth": (1, 4, 8, 1)}, False),
    ({}, {"rgb": (1, 8, 8, 3), "depth": (1, 8, 8, 5)}, False),
]


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
def test_can_pack_stems_matches_jax(case):
    config, shapes, calibrating = PACK_CASES[case]
    config = dict({"expert_model": "fcn"}, **config)
    modalities = list(shapes)
    want = jpe.can_pack_stems(JCtx({}, calibrate=calibrating),
                              _batch(shapes), modalities, config)
    got = tpe.can_pack_stems(Ctx({}, calibrate=calibrating), _batch(shapes),
                             modalities, config)
    assert got == want
