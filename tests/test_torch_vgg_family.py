"""VGG16, its progressive column, the adapter block, FusionFCN and
ProgressiveFCN in the port against the JAX package's, on the CPU.

32x48 frames, ``num_units`` 4, 5 classes, the VGG16 widths of the
reference (its stacks have no width factor). Layer tests make their
variables from the port's specs with numpy and feed the same arrays to
both packages; model tests carry the JAX model's variables across with
``from_jax_variables``. Neither model has batch norm by default, so one
float32 train step is well conditioned. Tolerances:

* the adapter block and model probabilities: within 1e-5 of the largest
  |value| of JAX's output; the layers of the VGG16 stacks within 1e-4 of
  it (13 float32 convs deep, reductions up to 4,608 terms each);
* labels equal;
* one train step with SGD(1.0) (its variable delta is the gradient): the
  loss at rtol 1e-5, each trainable tensor's delta within 1e-3 of the
  largest |delta| of JAX's tensor (at least 1e-3), frozen tensors bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.models import vgg16 as jvgg
from modular_semantic_segmentation_tpu.ops import init as jinit
from modular_semantic_segmentation_tpu.ops import layers as jll
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_tpu.ops.variables import \
    split_trainable as jax_split_trainable
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models import vgg16 as tvgg
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import init as tinit
from modular_semantic_segmentation_torch.ops import layers as tll
from modular_semantic_segmentation_torch.ops import optimizers
from modular_semantic_segmentation_torch.ops.variables import Ctx

NUM_CLASSES = 5
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
PREFIXES = {"rgb": "rgb", "depth": "depth"}
PROGRESSIVE = {"prefix": "depth", "modality": "depth",
               "lateral_columns": {"rgb": "rgb"}}


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
            "depth": rng.rand(n, 32, 48, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 48)).astype(np.int32)}


def _variables(specs, seed):
    """Numpy variables from the port's specs, the BN moving statistics and
    the adapter scales drawn at random, so that neither is trivial."""
    rng = np.random.RandomState(seed)
    out = {k: v.numpy() for k, v in tinit.build_variables(
        specs, seed=seed).items()}
    for k, v in out.items():
        if k.endswith(("moving_mean", "adapter/scale")):
            out[k] = (rng.rand(*v.shape) * 0.5 + 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
    return out


def _contexts(variables):
    return (JCtx({k: jnp.asarray(v) for k, v in variables.items()},
                 train=False),
            Ctx({k: torch.from_numpy(v) for k, v in variables.items()}))


def _assert_scaled_close(got, want, atol, name=""):
    """|got - want| within ``atol`` of max(|want|.max(), 1e-3)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=0, atol=atol, err_msg=name)


def _assert_layers_close(jlayers, tlayers):
    assert sorted(tlayers) == sorted(jlayers)
    for k, want in jlayers.items():
        _assert_scaled_close(tlayers[k].numpy(), want, 1e-4, k)


# ------------------------------------------------------------------ layers
def test_selection_picks_one_of_the_values():
    init = tinit.selection([1.0, 0.1])
    rng = np.random.RandomState(0)
    values = {np.float32(1.0), np.float32(0.1)}
    assert {init(rng, (3,))[0] for _ in range(20)} == values
    value = init(rng, (3,))
    assert value.dtype == np.float32 and len(set(value.tolist())) == 1
    jvalue = np.asarray(jinit.selection([1.0, 0.1])(
        JCtx({}, rng=jax.random.PRNGKey(0), init=True), (3,)))
    assert jvalue.shape == value.shape and jvalue[0] in values


@pytest.mark.parametrize("shape,dampened", [
    ((3, 3, 8, 4), True), ((3, 3, 8, 4), False), ((3, 3, 6, 5), True)])
def test_half_zeros_has_the_structure_of_jax(shape, dampened):
    """The same structure as JAX's: the first half of the input channels
    0.1 x Glorot (or zero), the second the centre identity when
    dim_in == 2 * dim_out, else Glorot."""
    got = tinit.half_zeros(dampened)(np.random.RandomState(0), shape)
    want = np.asarray(jinit.half_zeros(dampened)(
        JCtx({}, rng=jax.random.PRNGKey(0), init=True), shape))
    half = shape[2] // 2
    limit = np.sqrt(6.0 / (np.prod(shape[:2]) * (half + shape[3])))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    for value in (got, want):
        first, second = value[:, :, :half], value[:, :, half:]
        assert np.abs(first).max() <= (0.1 * limit if dampened else 0.0)
        if shape[2] == 2 * shape[3]:
            np.testing.assert_array_equal(second, want[:, :, half:])
        else:
            assert np.abs(second).max() <= limit and second.any()


@pytest.mark.parametrize("batchnorm", [False, True])
def test_vgg16_layers_match_jax(batchnorm):
    variables = _variables(tvgg.vgg16_variable_specs(
        "rgb", 3, batchnorm=batchnorm), seed=1)
    x = _frames(1)["rgb"]
    jctx, tctx = _contexts(variables)
    params = {"batch_normalization": batchnorm}
    _assert_layers_close(
        jvgg.vgg16(jctx, jnp.asarray(x), "rgb",
                   dict(params, activation=jax.nn.relu)),
        tvgg.vgg16(tctx, torch.from_numpy(x), "rgb", params))


@pytest.mark.parametrize("extra_convolution,columns,batchnorm", [
    (True, 1, False), (False, 1, False), (True, 2, True)])
def test_progressive_vgg16_layers_match_jax(extra_convolution, columns,
                                            batchnorm):
    """The progressive column over ``columns`` lateral VGG16 columns."""
    laterals = [f"lat{i}" for i in range(columns)]
    specs = tvgg.progressive_vgg16_variable_specs(
        "depth", 1, columns, batchnorm=batchnorm,
        extra_convolution=extra_convolution)
    for p in laterals:
        specs += tvgg.vgg16_variable_specs(p, 3)
    variables = _variables(specs, seed=2)
    frames = _frames(2)
    jctx, tctx = _contexts(variables)
    jcols, tcols = {}, {}
    for p in laterals:
        jcol = jvgg.vgg16(jctx, jnp.asarray(frames["rgb"]), p,
                          {"activation": jax.nn.relu,
                           "batch_normalization": False})
        tcol = tvgg.vgg16(tctx, torch.from_numpy(frames["rgb"]), p,
                          {"batch_normalization": False})
        for k in jcol:
            jcols.setdefault(k, []).append(jcol[k])
            tcols.setdefault(k, []).append(tcol[k])
    adapter = {"extra_convolution": extra_convolution}
    _assert_layers_close(
        jvgg.progressive_vgg16(
            jctx, jnp.asarray(frames["depth"]), jcols, "depth",
            {"activation": jax.nn.relu, "batch_normalization": batchnorm},
            adapter),
        tvgg.progressive_vgg16(
            tctx, torch.from_numpy(frames["depth"]), tcols, "depth",
            {"batch_normalization": batchnorm}, adapter))


@pytest.mark.parametrize("extra_convolution", [True, False])
def test_adap_conv_matches_jax(extra_convolution):
    """Two lateral inputs of 6 channels, x of 4, combination conv to 5
    with batch norm, under the JAX package's variable names."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 9, 4).astype(np.float32)
    laterals = [rng.randn(2, 7, 9, 6).astype(np.float32) for _ in range(2)]
    names = ["a/adapter/scale", "a/combination/kernel", "a/combination/bias",
             "a/combination/gamma", "a/combination/beta",
             "a/combination/moving_mean", "a/combination/moving_variance"]
    shapes = [(2,), (3, 3, 4 + (4 if extra_convolution else 12), 5)] + [
        (5,)] * 5
    if extra_convolution:
        names += ["a/adapter/adapter/kernel", "a/adapter/adapter/bias"]
        shapes += [(1, 1, 12, 4), (4,)]
    variables = {n: (rng.rand(*s) + 0.2).astype(np.float32) * 0.5
                 for n, s in zip(names, shapes)}
    jctx, tctx = _contexts(variables)
    want = jll.adap_conv(jctx, jnp.asarray(x),
                         [jnp.asarray(v) for v in laterals], 5, 3, name="a",
                         extra_convolution=extra_convolution,
                         batch_normalization=True)
    got = tll.adap_conv(tctx, torch.from_numpy(x),
                        [torch.from_numpy(v) for v in laterals], 5, 3,
                        name="a", extra_convolution=extra_convolution,
                        batch_normalization=True)
    _assert_scaled_close(got.numpy(), want, 1e-5)


# ------------------------------------------------------------------ models
def _config(name, **config):
    base = ({"prefixes": PREFIXES} if name == "fusion_fcn"
            else dict(PROGRESSIVE))
    return dict(base, data_description=DATA_DESCRIPTION, num_units=4,
                **config)


@pytest.fixture(scope="module")
def jax_nets():
    """The JAX models with their default configs, built once."""
    return {name: jax_model(name)(**_config(name))
            for name in ("fusion_fcn", "progressive_fcn")}


def _twin(jnet, name):
    """The port's model with the JAX model's variables."""
    tnet = get_model(name)(device="cpu", **_config(name))
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    return tnet, variables


@pytest.mark.parametrize("name,config", [
    ("fusion_fcn", {}),
    ("progressive_fcn", {}),
    ("progressive_fcn", {"batch_normalization": True}),
    ("progressive_fcn", {"adapter": {"extra_convolution": False,
                                     "initialize_half_zero": True}}),
])
def test_variables_and_trainable_map_match_jax(jax_nets, name, config):
    jnet = (jax_nets[name] if not config
            else jax_model(name)(**_config(name, **config)))
    tnet = get_model(name)(device="cpu", **_config(name, **config))
    want = {k: np.asarray(v).shape for k, v in jnet.variables.items()}
    assert {k: tuple(v.shape) for k, v in tnet.variables.items()} == want
    assert tnet.trainable == {k: bool(v) for k, v in jnet.trainable.items()}
    if name == "progressive_fcn":
        assert not tnet.trainable["rgb_conv1_1/kernel"]
        assert tnet.trainable["depth_conv1_2/adapter/scale"]
        assert tnet.trainable["depth_conv1_2/combination/kernel"]
        assert not tnet.trainable["depth_upscore_conv5/kernel"]
    else:
        assert tnet.trainable["rgb_conv1_1/kernel"]
        assert not tnet.trainable["fused/upscore/kernel"]
        assert tnet.config["trainer"] == "rmsprop"
        assert tnet.ptq_min_pixels == jnet.ptq_min_pixels == 0


@pytest.mark.parametrize("name", ["fusion_fcn", "progressive_fcn"])
def test_forward_matches_jax(jax_nets, name):
    jnet = jax_nets[name]
    tnet, _ = _twin(jnet, name)
    data = _frames(4)
    _assert_scaled_close(tnet.predict(data, output_attr="prob"),
                         jnet.predict(data, output_attr="prob"), 1e-5)
    got = tnet.predict(data)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnet.predict(data))


@pytest.mark.parametrize("name", ["fusion_fcn", "progressive_fcn"])
def test_bf16_forward_matches_jax(name):
    """The bfloat16 forward against JAX's bfloat16 forward, under the
    near-tie rule of tests/test_torch_bf16_fusion.py: at most 2% of the
    labels differ, each where the port's probability of JAX's label lies
    within 2**-5 (relative) of its own label's."""
    config = _config(name, compute_dtype="bfloat16")
    jnet = jax_model(name)(**config)
    tnet = get_model(name)(device="cpu", **config)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    data = _frames(4)
    prob = tnet.predict(data, output_attr="prob")
    got, want = tnet.predict(data), jnet.predict(data)
    assert got.dtype == np.int32
    differ = got != want
    assert differ.mean() <= 0.02
    own = np.take_along_axis(prob, got[..., None], -1)[..., 0][differ]
    other = np.take_along_axis(prob, want[..., None].astype(np.int64),
                               -1)[..., 0][differ]
    assert np.all(own - other <= 2.0 ** -5 * own)
    _assert_scaled_close(prob, jnet.predict(data, output_attr="prob"),
                         2.0 ** -5)


def _pool_routes(tnet, batch, dtype, monkeypatch):
    """The argmax of every max-pool window in the port's train-mode
    forward with variables and convs in ``dtype``."""
    routes = []

    def recorded(ctx, x, pool_size, strides):
        out, idx = F.max_pool2d(x.permute(0, 3, 1, 2), pool_size, strides,
                                return_indices=True)
        routes.append(idx)
        return out.permute(0, 2, 3, 1)
    with monkeypatch.context() as patch:
        patch.setattr(tll, "max_pool2d", recorded)
        tnet.compute_dtype = dtype
        try:
            tnet._microbatch_grads(
                {k: v.to(dtype) for k, v in tnet.variables.items()},
                tnet._batch_to_device(batch))
        finally:
            tnet.compute_dtype = torch.float32
    return routes


@pytest.mark.parametrize("name", ["fusion_fcn", "progressive_fcn"])
def test_sgd_step_matches_jax(jax_nets, name, monkeypatch):
    """On a batch whose max-pool windows the port routes alike in float32
    and float64 (checked here): a window whose two largest inputs are
    within rounding sends its gradient to another input in one package
    than in the other, which moves the convs before that pool by a few
    percent of their scale (ROADMAP.md section 3, item 11)."""
    jnet = jax_nets[name]
    tnet, start = _twin(jnet, name)
    jnet._optimizer = optax.sgd(1.0)
    opt_state = jnet._optimizer.init(
        jax_split_trainable(jnet.variables, jnet.trainable)[0])
    tnet._optimizer = optimizers.SGD(1.0)
    batch = _frames(6, n=1)
    for a, b in zip(*(_pool_routes(tnet, batch, dtype, monkeypatch)
                      for dtype in (torch.float32, torch.float64))):
        assert torch.equal(a, b), "a pool window routes at a near tie"
    jnew, _, jloss = jax.jit(jnet._train_step)(
        jnet.variables, opt_state, batch, jax.random.PRNGKey(0))
    tnew, _, tloss = tnet._train_step(tnet.variables, {}, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k, before in start.items():
        if jnet.trainable[k]:
            want = np.asarray(jnew[k]) - before
            _assert_scaled_close(tnew[k].numpy() - before, want, 1e-3, k)
        else:
            np.testing.assert_array_equal(tnew[k].numpy(), before,
                                          err_msg=k)


def test_fit_keeps_the_lateral_column():
    """Two adam steps of ProgressiveFCN: the lateral column is bit for bit
    what it was, the adapters' scales and the new column moved."""
    net = get_model("progressive_fcn")(
        device="cpu", batchsize=1, learning_rate=0.01,
        **_config("progressive_fcn"))
    before = {k: v.clone() for k, v in net.variables.items()}
    net.fit(_frames(6), 2, output=False)
    lateral = [k for k in before if k.startswith("rgb_")]
    assert len(lateral) == 26
    for k in lateral:
        assert torch.equal(net.variables[k], before[k]), k
    for k in ("depth_conv1_2/adapter/scale", "depth_conv5_3/adapter/scale",
              "depth_conv1_1/kernel", "depth_conv1_2/combination/kernel"):
        assert not torch.equal(net.variables[k], before[k]), k
