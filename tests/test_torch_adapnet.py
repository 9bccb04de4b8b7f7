"""AdapNet and the layer parts it needs, in the port against the JAX
package's, on the CPU.

32x48 frames, ``num_units`` 4, 5 classes, JAX variables carried across
with ``from_jax_variables``; the JAX model is built once for the module.
Tolerances:

* the trainable deconv against JAX's ``dense_phase_upsample``: output
  within 1e-5 of the largest |value|, its kernel and input gradients
  within 1e-4 of the largest |gradient|;
* the bias-less convs within 1e-5 of the largest |value| (rtol 1e-6 in
  int8, on inputs the quantization keeps exact);
* the forward: ``prob`` within 1e-5, ``prediction`` int32 and equal where
  the top two probabilities are more than 1e-5 apart;
* gradients (``deconv2d``, the whole network): within 1e-3 of the largest
  |gradient| of JAX's tensor (at least 1e-3).

The whole network's gradient is held with batch norm from fixed moving
statistics, an affine map. With batch norm in train mode, AdapNet's
float32 train step at random initialization is ill-conditioned at these
sizes: on the step test's batch, JAX's own float32 deltas part from a
float64 evaluation of the same step by 1.68% in L2 over all tensors and
by 0.22 of one tensor's scale (a beta of the last block). So the
train-mode step is held by its loss (rtol 1e-4), by its moving
statistics' updates (within 5e-3 of scale), by what it moves, by how far
its deltas lie from float64 beside JAX's (``test_sgd_step_matches_jax``
asserts JAX's spread), and by train-mode batch norm's gradient at the
layer (within 1e-5 of scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modular_semantic_segmentation_tpu.models import adapnet as jadapnet
from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import fast_upsample as jfu
from modular_semantic_segmentation_tpu.ops import layers as jll
from modular_semantic_segmentation_tpu.ops import losses as jlosses
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_tpu.ops.variables import \
    split_trainable as jax_split_trainable
from modular_semantic_segmentation_torch.models import adapnet as tadapnet
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import init as tinit
from modular_semantic_segmentation_torch.ops import layers as tll
from modular_semantic_segmentation_torch.ops import optimizers
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.ops.variables import Ctx

NUM_CLASSES = 5
NUM_UNITS = 4
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)
CONFIG = {"modality": "rgb", "num_units": NUM_UNITS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, item 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed, n=2):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 48, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 48)).astype(np.int32)}


def _assert_scaled_close(got, want, atol, name=""):
    """|got - want| within ``atol`` of max(|want|.max(), 1e-3)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jnet():
    return jax_model("adapnet")(DATA_DESCRIPTION, **CONFIG)


def _twin(jnet, variables=None):
    """The port's Adapnet with the JAX model's (or the given) variables."""
    tnet = get_model("adapnet")(DATA_DESCRIPTION, device="cpu", **CONFIG)
    if variables is None:
        variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    return tnet, variables


def _eval_variables(jnet, seed):
    """The JAX model's variables with BN moving statistics drawn at random
    (means 0.1 * N(0, 1), variances in [0.5, 1.5)), so that eval-mode BN is
    a non-trivial affine map."""
    rng = np.random.RandomState(seed)
    out = {k: np.asarray(v) for k, v in jnet.variables.items()}
    for k, v in out.items():
        if k.endswith("moving_mean"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
    return out


def _zero_windows(stem):
    """How many 2x2 windows of the stem pool's input (block_0_2, after BN
    and ReLU) are all zero: exact ties."""
    n, h, w, c = stem.shape
    windows = stem.detach().reshape(n, h // 2, 2, w // 2, 2, c)
    return int((windows.amax(dim=(2, 4)) == 0).sum())


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("k,s,cin,cout", [(4, 2, 6, 3), (16, 8, 5, 4)])
def test_trainable_deconv_matches_jax_dense_phase_upsample(k, s, cin, cout):
    """A trainable dense deconv at AdapNet's two upconvs (4x4/s2,
    16x16/s8): the port's ``conv_transpose2d`` + crop against the JAX
    package's route for it, ``dense_phase_upsample``; forward, and the
    kernel and input gradients against jax.grad's."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 3, 5, cin).astype(np.float32)
    kernel = rng.randn(k, k, cout, cin).astype(np.float32)
    ct = rng.randn(2, 3 * s, 5 * s, cout).astype(np.float32)

    def jax_deconv(a, kern):
        return jll.deconv2d(JCtx({"d/kernel": kern}, train=False), a, cout,
                            k, "d", strides=s, batch_normalization=False,
                            trainable=True)
    want = jfu.dense_phase_upsample(jnp.asarray(x), jnp.asarray(kernel), s)
    _assert_scaled_close(jax_deconv(jnp.asarray(x), jnp.asarray(kernel)),
                         want, 1e-6, "JAX's deconv2d route")
    jgx, jgk = jax.grad(lambda a, b: jnp.sum(jax_deconv(a, b) * ct),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kernel))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(kernel).requires_grad_()
    got = tll.deconv2d(Ctx({"d/kernel": tk}), tx, cout, k, "d", strides=s,
                       batch_normalization=False, trainable=True)
    tgx, tgk = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                   (tx, tk))
    _assert_scaled_close(got.detach().numpy(), want, 1e-5)
    _assert_scaled_close(tgx.numpy(), jgx, 1e-4, "input gradient")
    _assert_scaled_close(tgk.numpy(), jgk, 1e-4, "kernel gradient")


@pytest.mark.parametrize("trainable,use_bias", [(True, True),
                                               (False, False)])
def test_deconv_kernel_gradient_matches_jax(trainable, use_bias):
    """A square-channel bilinear (channel-diagonal) kernel: trainable, it
    takes the dense ``conv_transpose2d`` and its off-diagonal weights get
    JAX's gradient;
    frozen, the depthwise path gives the same output."""
    rng = np.random.RandomState(5)
    c, k, s = 3, 4, 2
    x = rng.randn(1, 4, 6, c).astype(np.float32)
    kernel = tinit.bilinear_filter((k, k, c, c))
    bias = {"d/bias": rng.randn(c).astype(np.float32)} if use_bias else {}
    ct = rng.randn(1, 4 * s, 6 * s, c).astype(np.float32)

    def jax_loss(kern):
        ctx = JCtx({"d/kernel": kern, **bias}, train=False)
        out = jll.deconv2d(ctx, jnp.asarray(x), c, k, "d", strides=s,
                           batch_normalization=False, trainable=trainable,
                           use_bias=use_bias)
        return jnp.sum(out * ct), out
    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(kernel))
    tk = torch.from_numpy(kernel).requires_grad_()
    got = tll.deconv2d(Ctx({"d/kernel": tk, **from_jax_variables(
        bias, device="cpu")}), torch.from_numpy(x), c, k, "d", strides=s,
        batch_normalization=False, trainable=trainable, use_bias=use_bias)
    (tgrad,) = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), tk)
    _assert_scaled_close(got.detach().numpy(), want, 1e-5)
    if trainable:
        off = np.ones((c, c), bool) & ~np.eye(c, dtype=bool)
        assert np.abs(np.asarray(jgrad)[:, :, off]).max() > 0.1
        _assert_scaled_close(tgrad.numpy(), jgrad, 1e-3)


@pytest.mark.parametrize("shape,kernel,stride,dilation,bn", [
    ((1, 16, 24, 5), 7, 2, 1, True),   # the stem's 7x7/s2: pads (2, 3)
    ((1, 8, 12, 6), 1, 2, 1, True),    # the blocks' 1x1/s2
    ((1, 2, 3, 4), 3, 1, 16, True),    # dilation 16 on a 2x3 map
    ((2, 9, 11, 5), 3, 1, 2, False),
])
def test_conv2d_without_bias_matches_jax(shape, kernel, stride, dilation,
                                         bn):
    """``use_bias=False`` reads no bias variable (there is none)."""
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    variables = {"c/kernel": (rng.randn(kernel, kernel, shape[-1], 7)
                              * 0.3).astype(np.float32)}
    if bn:
        variables.update({
            "c/gamma": rng.rand(7).astype(np.float32) + 0.5,
            "c/beta": rng.randn(7).astype(np.float32),
            "c/moving_mean": rng.randn(7).astype(np.float32),
            "c/moving_variance": rng.rand(7).astype(np.float32) + 0.1})
    want = jll.conv2d(JCtx({k: jnp.asarray(v) for k, v in variables.items()},
                           train=False), jnp.asarray(x), 7, kernel, "c",
                      strides=stride, dilation_rate=dilation, use_bias=False,
                      batch_normalization=bn)
    ctx = Ctx(from_jax_variables(variables, device="cpu"))
    got = tll.conv2d(ctx, torch.from_numpy(x), 7, kernel, "c",
                     strides=stride, dilation_rate=dilation, use_bias=False,
                     batch_normalization=bn)
    assert got.dtype == torch.float32
    _assert_scaled_close(got.numpy(), want, 1e-5)
    bf16 = Ctx(ctx.variables, compute_dtype=torch.bfloat16)
    assert tll.conv2d(bf16, torch.from_numpy(x), 7, kernel, "c",
                      strides=stride, dilation_rate=dilation, use_bias=False,
                      batch_normalization=bn).dtype == torch.bfloat16


def test_int8_conv2d_without_bias_matches_jax():
    """The int8 branch of a bias-less conv (a 1x1/s2 block conv): no bias
    read or added. Inputs on the int8 grid of a power-of-two scale, so
    the quantization is exact in both packages."""
    rng = np.random.RandomState(9)
    ascale = 2.0 ** -6
    x = (rng.randint(-127, 128, (1, 8, 12, 16)) * ascale).astype(np.float32)
    variables = {"c/kernel": rng.randn(1, 1, 16, 8).astype(np.float32)}
    scales = {"c/input_amax": ascale}
    want = jll.conv2d(JCtx({"c/kernel": jnp.asarray(variables["c/kernel"])},
                           act_scales=scales), jnp.asarray(x), 8, 1, "c",
                      strides=2, use_bias=False, activation=None)
    got = tll.conv2d(Ctx(from_jax_variables(variables, device="cpu"),
                         act_scales=scales), torch.from_numpy(x), 8, 1, "c",
                     strides=2, use_bias=False, activation=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_max_pool_routes_ties_to_the_first_maximum():
    """The stem pool's gradient against the JAX package's mask gradient
    (``custom_grad``), on windows with ties: all-zero windows (ReLU
    output) and tied positive maxima."""
    rng = np.random.RandomState(7)
    x = (rng.randint(0, 3, (2, 8, 12, 5)) * 0.5).astype(np.float32)
    x[0, :4, :4] = 0.0
    ct = rng.randn(2, 4, 6, 5).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jll.max_pool2d(
        None, v, 2, 2, custom_grad=True) * ct))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tll.max_pool2d(None, tx, 2, 2)
    (got,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_train_batch_norm_gradient_matches_jax(scale):
    """Train-mode batch norm's input, gamma and beta gradients on a 2x3
    map (AdapNet's deepest at 32x48), against jax.grad's."""
    rng = np.random.RandomState(8)
    x = (rng.randn(1, 2, 3, 6) * scale + 1.0).astype(np.float32)
    ct = rng.randn(1, 2, 3, 6).astype(np.float32)
    variables = {"bn/gamma": rng.rand(6) + 0.5, "bn/beta": rng.randn(6),
                 "bn/moving_mean": np.zeros(6), "bn/moving_variance":
                 np.ones(6)}
    variables = {k: v.astype(np.float32) for k, v in variables.items()}

    def jax_loss(v, a):
        return jnp.sum(jll.batch_norm(JCtx(v, train=True), a, "bn") * ct)
    jv = {k: jnp.asarray(v) for k, v in variables.items()}
    jgv, jgx = jax.grad(jax_loss, argnums=(0, 1))(jv, jnp.asarray(x))
    tv = {k: torch.from_numpy(v).requires_grad_()
          for k, v in variables.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tll.batch_norm(Ctx(tv, train=True), tx, "bn")
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                (tx, tv["bn/gamma"], tv["bn/beta"]))
    for got, want in zip(grads, (jgx, jgv["bn/gamma"], jgv["bn/beta"])):
        _assert_scaled_close(got.numpy(), want, 1e-5)


# ------------------------------------------------------------------- model
def test_variables_and_trainable_map_match_jax(jnet):
    tnet = get_model("adapnet")(DATA_DESCRIPTION, device="cpu", **CONFIG)
    want = {k: np.asarray(v).shape for k, v in jnet.variables.items()}
    assert {k: tuple(v.shape) for k, v in tnet.variables.items()} == want
    assert len(want) == 334
    assert sum(int(np.prod(s)) for s in want.values()) == 27_990_648
    assert tnet.trainable == {k: bool(v) for k, v in jnet.trainable.items()}
    for k in ("rgb/first_deconvolution_upconv/kernel",
              "rgb/second_deconvolution_upconv/kernel"):
        assert tnet.trainable[k]
    assert "rgb/block_layer_1/stage_1/bias" not in tnet.variables
    assert tnet.ptq_min_pixels == jnet.ptq_min_pixels == 2048


def test_forward_matches_jax(jnet):
    """Eval mode, BN from random moving statistics."""
    data = _frames(1)
    tnet, variables = _twin(jnet, _eval_variables(jnet, 1))
    jnet_variables = jnet.variables
    jnet.variables = {k: jnp.asarray(v) for k, v in variables.items()}
    try:
        want = jnet.predict(data, output_attr="prob")
        want_labels = jnet.predict(data)
    finally:
        jnet.variables = jnet_variables
    got = tnet.predict(data, output_attr="prob")
    _assert_scaled_close(got, want, 1e-5)
    labels = tnet.predict(data)
    assert labels.dtype == np.int32
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    np.testing.assert_array_equal(labels[clear], want_labels[clear])
    assert clear.mean() > 0.9


def test_gradient_matches_jax(jnet):
    """The whole network's loss gradient (every conv, the strided and
    dilated ones, the two trainable dense deconvs, the stem pool with its
    all-zero windows, the residual adds) against jax.grad's, with batch
    norm from fixed moving statistics."""
    data = _frames(2, n=1)
    tnet, variables = _twin(jnet, _eval_variables(jnet, 2))
    onehot = np.asarray(jax.nn.one_hot(data["labels"], NUM_CLASSES))
    names = [k for k, train in tnet.trainable.items() if train]

    def jax_loss(train_vars, frozen, x, labels):
        ctx = JCtx({**frozen, **train_vars}, train=False)
        score = jadapnet.adapnet(ctx, x, "rgb", NUM_UNITS,
                                 NUM_CLASSES)["score"]
        return jlosses.cross_entropy(jll.log_softmax(score), labels)
    jgrads = jax.jit(jax.grad(jax_loss))(
        {k: jnp.asarray(variables[k]) for k in names},
        {k: jnp.asarray(v) for k, v in variables.items() if k not in names},
        jnp.asarray(data["rgb"]), jnp.asarray(onehot))

    leaves = {k: torch.from_numpy(variables[k]).requires_grad_()
              for k in names}
    frozen = {k: torch.from_numpy(v) for k, v in variables.items()
              if k not in names}
    ctx = Ctx({**frozen, **leaves})
    layers = tadapnet.adapnet(ctx, torch.from_numpy(data["rgb"]), "rgb",
                              NUM_UNITS, NUM_CLASSES)
    loss = cross_entropy(tll.log_softmax(layers["score"]),
                         torch.from_numpy(onehot.copy()))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert _zero_windows(layers["block_0_2"]) > 0
    for k, got in zip(names, grads):
        _assert_scaled_close(got.numpy(), jgrads[k], 1e-3, k)


def _step_deltas(new, start):
    return {k: np.asarray(new[k], np.float64) - start[k].astype(np.float64)
            for k in start}


def _delta_l2(got, want, names):
    """The L2 distance of one step's deltas from another's over the
    tensors ``names``, over the L2 norm of ``want``'s."""
    return (sum(((got[k] - want[k]) ** 2).sum() for k in names)
            / sum((want[k] ** 2).sum() for k in names)) ** 0.5


def test_sgd_step_matches_jax(jnet):
    """One train step with SGD(1.0), batch norm in train mode, one batch
    with all-zero stem-pool windows, against JAX's ``_train_step`` and a
    float64 evaluation of the same step (the port's: the JAX package's
    batch norm computes in float32 whatever its input).

    Held: the loss at rtol 1e-4; each moving statistic's update (a
    forward quantity) elementwise within 5e-3 of its largest |update|
    (at least 1e-3; reading 1.2e-3, and JAX's own float32 update lies
    9.1e-4 from float64's); every kernel, gamma, beta and moving statistic
    moves in both packages (a conv bias before train-mode BN has a
    gradient of about 0). The trainable deltas are not held elementwise:
    JAX's own float32 step parts from float64 by more than 1% in L2 over
    all of them (reading 1.68e-2; 0.22 of one beta's scale), which this
    test asserts, and the port's lies no further than three times that
    from float64 (reading 2.53e-2)."""
    tnet, start = _twin(jnet)
    batch = _frames(3, n=1)
    opt = optax.sgd(1.0)
    opt_state = opt.init(jax_split_trainable(jnet.variables,
                                             jnet.trainable)[0])
    saved = jnet._optimizer
    jnet._optimizer = opt
    try:
        jnew, _, jloss = jax.jit(jnet._train_step)(
            jnet.variables, opt_state, batch, jax.random.PRNGKey(0))
    finally:
        jnet._optimizer = saved
    with torch.no_grad():
        stem = tadapnet.adapnet(Ctx(tnet.variables, train=True),
                                torch.from_numpy(batch["rgb"]), "rgb",
                                NUM_UNITS, NUM_CLASSES)["block_0_2"]
    assert _zero_windows(stem) > 0
    tnet._optimizer = optimizers.SGD(1.0)
    tnew, _, tloss = tnet._train_step(tnet.variables, {}, batch)
    tnet.compute_dtype = torch.float64
    t64, _, _ = tnet._train_step(
        {k: v.double() for k, v in tnet.variables.items()}, {}, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    moving = ("/kernel", "/gamma", "/beta", "/moving_mean",
              "/moving_variance")
    assert all(k.endswith(moving + ("/bias",)) for k in start)
    for k, before in start.items():
        if k.endswith(moving):
            assert not np.array_equal(tnew[k].numpy(), before), k
            assert not np.array_equal(np.asarray(jnew[k]), before), k
    port, jax32, f64 = (_step_deltas(new, start) for new in (tnew, jnew,
                                                             t64))
    statistics = [k for k in start if k.endswith(("/moving_mean",
                                                  "/moving_variance"))]
    for k in statistics:
        _assert_scaled_close(port[k], jax32[k], 5e-3, k)
    trained = [k for k, train in tnet.trainable.items() if train]
    jax_spread = _delta_l2(jax32, f64, trained)
    assert jax_spread > 1e-2, jax_spread
    assert _delta_l2(port, f64, trained) <= 3 * jax_spread


def test_quantize_for_serving_raises():
    """int8 serving of AdapNet is ported: ``quantize_for_serving`` raises
    no more. At 32x48 no conv input reaches AdapNet's floor of 2048
    positions, so it selects no conv and serving stays float, as the JAX
    package's does; with the floor at 0 it selects JAX's convs."""
    frames = _frames(9)
    net = get_model("adapnet")(DATA_DESCRIPTION, device="cpu", **CONFIG)
    jnet = jax_model("adapnet")(data_description=DATA_DESCRIPTION, **CONFIG)
    net.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    assert net.quantize_for_serving(frames, num_batches=1) == {}
    assert jnet.quantize_for_serving(frames, num_batches=1) == {}
    assert net.act_scales is None
    got = net.quantize_for_serving(frames, num_batches=1, min_pixels=0)
    want = jnet.quantize_for_serving(frames, num_batches=1, min_pixels=0)
    assert got and set(got) == set(want)
