"""Training in the port against the JAX package's, on the CPU.

Small models (32x32 frames, ``num_units=4``, the full VGG16 depth at
``channel_factor=0.25``, batch 2 or 4) whose JAX variables are carried
across with ``from_jax_variables``, and batches made with numpy from a
seed, so both packages see the same data. Tolerances:

* ``cross_entropy``: rtol 1e-6.
* train-mode ``batch_norm``: output and recorded moving statistics at
  rtol 1e-5, atol 1e-6.
* one train step with SGD(1.0) (its variable delta is the gradient;
  adaptive optimizers would amplify the reduction-order noise of near-zero
  gradients into steps of the learning rate): the loss at rtol 1e-5; each
  variable's delta divided by the largest |delta| of JAX's tensor (at
  least 1e-3) within atol 1e-3; the new BN moving statistics at rtol
  1e-5, atol 1e-6. The same for the microbatched step.
* three adagrad steps: each variable's delta from the start and each
  accumulator's growth from its start of 0.1, divided by the largest
  |delta| (|growth|) of JAX's tensor (at least 1e-3), within atol 1e-3.
  Without batch norm: with it, at these sizes the deep layers normalize
  over 8 values a channel (2x2 maps, batch 2), and a float32 step of
  either package can part from a float64 evaluation of the same step by
  several percent of a tensor's scale on some random batches (the JAX
  package's at the raw-image conv1_1, the port's at conv4_2 after three
  steps), so trajectories over several steps part too. One step with
  batch norm is held on a batch where both agree with float64.
* remat against plain, both in the port: loss rtol 1e-6, variables rtol
  1e-4, atol 1e-6.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import layers as jax_layers
from modular_semantic_segmentation_tpu.ops import losses as jax_losses
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JaxCtx
from modular_semantic_segmentation_tpu.ops.variables import \
    split_trainable as jax_split_trainable
from modular_semantic_segmentation_tpu.utils import data_io as jax_data_io
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops import optimizers
from modular_semantic_segmentation_torch.ops.losses import (
    cross_entropy, one_hot)
from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.utils import data_io

NUM_CLASSES = 5
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)
SMALL = {"prefix": "rgb", "modality": "rgb",
         "data_description": DATA_DESCRIPTION, "num_units": 4,
         "channel_factor": 0.25}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, item 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, n=2, size=32):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, size, size, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, size, size)).astype(np.int32)}


def _blocks(seed, n, size=32, classes=NUM_CLASSES):
    """Frames whose labels are a learnable function of the input: the red
    channel of 8x8 blocks quantized to the classes, noise on top, the two
    top rows void."""
    rng = np.random.RandomState(seed)
    blocks = rng.rand(n, size // 8, size // 8, 3)
    rgb = (np.repeat(np.repeat(blocks, 8, 1), 8, 2) * 255
           + rng.rand(n, size, size, 3) * 8)
    labels = np.minimum((blocks[..., 0] * classes).astype(np.int32),
                        classes - 1)
    labels = np.repeat(np.repeat(labels, 8, 1), 8, 2)
    labels[:, :2] = -1
    return {"rgb": rgb.astype(np.float32), "labels": labels}


@pytest.fixture(scope="module")
def jax_nets():
    """JAX models by (name, config), built once for the module."""
    built = {}

    def get(name, **config):
        key = (name, tuple(sorted(config.items())))
        if key not in built:
            built[key] = jax_model(name)(**SMALL, **config)
        return built[key]
    return get


def _twin(jnet, name, **config):
    """The port's model with the JAX model's variables and trainable map."""
    tnet = get_model(name)(device="cpu", **SMALL, **config)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    tnet.trainable = _trainable(jnet)
    return tnet, variables


def _trainable(jnet):
    """The JAX model's ``net.trainable`` as the port's ``{name: bool}``."""
    return {k: bool(v) for k, v in jnet.trainable.items()}


def _sgd(jnet, tnet):
    """Both models on SGD(1.0), whose step's delta is the gradient."""
    jnet._optimizer = optax.sgd(1.0)
    jnet.opt_state = jnet._optimizer.init(
        jax_split_trainable(jnet.variables, jnet.trainable)[0])
    tnet._optimizer = optimizers.SGD(1.0)
    tnet.opt_state = {}


def _assert_scaled_close(got, want, reference, name):
    """|got - want| / max(|reference|.max(), 1e-3) within 1e-3."""
    scale = max(float(np.abs(reference).max()), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=1e-3, err_msg=name)


def _assert_step_matches(jnet, jnew, jloss, tnew, tloss, start):
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k, before in start.items():
        jv, tv = np.asarray(jnew[k]), tnew[k].numpy()
        if k.endswith(("moving_mean", "moving_variance")):
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        elif jnet.trainable[k]:
            _assert_scaled_close(tv - before, jv - before, jv - before, k)
        else:
            np.testing.assert_array_equal(tv, before, err_msg=k)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("void_rows", [False, True])
def test_cross_entropy_matches_jax(void_rows):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 6, 7, NUM_CLASSES).astype(np.float32)
    labels = rng.randint(-1, NUM_CLASSES, (2, 6, 7)).astype(np.int32)
    if void_rows:
        labels[:, :3] = -1
        labels[1] = -1
    log_p = np.array(jax.nn.log_softmax(logits))
    onehot = np.array(jax.nn.one_hot(labels, NUM_CLASSES))
    np.testing.assert_array_equal(
        one_hot(torch.from_numpy(labels), NUM_CLASSES).numpy(), onehot)
    want = float(jax_losses.cross_entropy(log_p, onehot))
    got = float(cross_entropy(torch.from_numpy(log_p),
                              torch.from_numpy(onehot)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # every row void: 0 / (1e-20 + 0), no NaN
    assert float(cross_entropy(torch.from_numpy(log_p),
                               torch.zeros_like(torch.from_numpy(onehot)))
                 ) == 0.0


@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_train_batch_norm_matches_jax(scale):
    """Batch statistics normalize and the moving statistics take
    0.99 * moving + 0.01 * batch (biased variance, two passes), on
    centred inputs and on raw [0, 255) image values."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 6, 8) if scale == 1.0
         else rng.rand(3, 5, 6, 8) * scale).astype(np.float32)
    variables = {"bn/gamma": rng.rand(8) + 0.5, "bn/beta": rng.randn(8),
                 "bn/moving_mean": rng.randn(8),
                 "bn/moving_variance": rng.rand(8) + 0.5}
    variables = {k: v.astype(np.float32) for k, v in variables.items()}
    jctx = JaxCtx(dict(variables), train=True)
    want = np.asarray(jax_layers.batch_norm(jctx, x, "bn"))
    tctx = Ctx(from_jax_variables(variables, device="cpu"), train=True)
    got = ll.batch_norm(tctx, torch.from_numpy(x), "bn").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert sorted(tctx.updates) == sorted(jctx.updates)
    for k, v in jctx.updates.items():
        np.testing.assert_allclose(tctx.updates[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # eval mode records nothing
    ectx = Ctx(from_jax_variables(variables, device="cpu"))
    ll.batch_norm(ectx, torch.from_numpy(x), "bn")
    assert ectx.updates == {}


@pytest.mark.parametrize("name,config", [
    ("simple_fcn", {}),
    ("simple_fcn", {"train_encoder": False}),
    ("simple_fcn", {"batch_normalization": False}),
    ("simple_fcn", {"train_encoder": False, "batch_normalization": False}),
    ("bayesian_fcn", {}),
])
def test_trainable_map_matches_jax(jax_nets, name, config):
    jnet = jax_nets(name, **config)
    tnet = get_model(name)(device="cpu", **SMALL, **config)
    assert tnet.trainable == _trainable(jnet)
    assert not tnet.trainable["rgb/upscore/kernel"]
    assert sorted(tnet.opt_state["mu"]) == sorted(
        k for k, train in jnet.trainable.items() if train)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("name,config", [
    ("simple_fcn", {}),
    ("simple_fcn", {"batch_normalization": False}),
    ("bayesian_fcn", {"dropout_rate": 0.0}),
])
def test_sgd_step_matches_jax(jax_nets, name, config):
    jnet = jax_nets(name, **config)
    tnet, start = _twin(jnet, name, **config)
    _sgd(jnet, tnet)
    batch = _batch(2)
    jnew, _, jloss = jnet._train_step(jnet.variables, jnet.opt_state, batch,
                                      jax.random.PRNGKey(0))
    tnew, _, tloss = tnet._train_step(tnet.variables, tnet.opt_state, batch)
    _assert_step_matches(jnet, jnew, jloss, tnew, tloss, start)
    # the step is pure: the model's own variables did not change
    for k, v in start.items():
        np.testing.assert_array_equal(tnet.variables[k].numpy(), v)


def test_bf16_sgd_step_matches_jax(jax_nets):
    """One bfloat16 train step with batch norm (the batch and config of
    test_sgd_step_matches_jax) against JAX's bfloat16 step.

    At these sizes either package's bf16 step parts from its own float32
    step by 40-110% of a tensor's scale, yet the two bf16 steps agree far
    closer: the loss within rtol 2**-8 (a bf16 step), each moving
    statistic's update within 2**-8 of the largest |update| of JAX's
    tensor, each trainable kernel, gamma and beta's delta within 2**-4 of
    the largest |delta| of JAX's (at least 1e-3). A conv bias that feeds
    batch norm has no gradient in exact arithmetic (BN subtracts the
    batch mean; float32 gives deltas of 1e-9 to 1e-7): in bf16 its delta
    is rounding, held below 2**-8 of its layer kernel's largest |delta|
    in both packages."""
    jnet = jax_nets("simple_fcn", compute_dtype="bfloat16")
    tnet, start = _twin(jnet, "simple_fcn", compute_dtype="bfloat16")
    _sgd(jnet, tnet)
    batch = _batch(2)
    jnew, _, jloss = jnet._train_step(jnet.variables, jnet.opt_state, batch,
                                      jax.random.PRNGKey(0))
    tnew, _, tloss = tnet._train_step(tnet.variables, tnet.opt_state, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2.0 ** -8)
    deltas = {k: (tnew[k].numpy() - v, np.asarray(jnew[k]) - v)
              for k, v in start.items()}
    for k, (got, want) in deltas.items():
        scope = k.rsplit("/", 1)[0]
        if k.endswith(("moving_mean", "moving_variance")):
            scale = float(np.abs(want).max())
            assert np.abs(got - want).max() <= 2.0 ** -8 * scale, k
        elif not jnet.trainable[k]:
            np.testing.assert_array_equal(got, 0.0, err_msg=k)
        elif k.endswith("/bias") and f"{scope}/moving_mean" in start:
            kernel = float(np.abs(deltas[f"{scope}/kernel"][1]).max())
            for delta in (got, want):
                assert np.abs(delta).max() <= 2.0 ** -8 * kernel, k
        else:
            scale = max(float(np.abs(want).max()), 1e-3)
            assert np.abs(got - want).max() <= 2.0 ** -4 * scale, k


def test_adagrad_three_steps_match_jax(jax_nets):
    config = {"trainer": "adagrad", "learning_rate": 0.01,
              "batch_normalization": False}
    jnet = jax_nets("simple_fcn", **config)
    tnet, start = _twin(jnet, "simple_fcn", **config)
    names = [k for k, train in tnet.trainable.items() if train]
    tnet.opt_state = optimizers.state_from_leaves(
        tnet._optimizer, jax.tree_util.tree_flatten(jnet.opt_state)[0],
        names, "cpu")
    jv, jo = jnet.variables, jnet.opt_state
    tv, to = tnet.variables, tnet.opt_state
    for seed in (3, 4, 5):
        batch = _batch(seed)
        jv, jo, _ = jnet._train_step(jv, jo, batch, jax.random.PRNGKey(seed))
        tv, to, _ = tnet._train_step(tv, to, batch)
    for k, before in start.items():
        want = np.asarray(jv[k]) - before
        if not jnet.trainable[k]:
            np.testing.assert_array_equal(tv[k].numpy(), before, err_msg=k)
            continue
        assert np.abs(want).max() > 0, k
        _assert_scaled_close(tv[k].numpy() - before, want, want, k)
    leaves = jax.tree_util.tree_flatten(jo)[0]
    assert len(leaves) == len(names)
    for k, want in zip(sorted(names), leaves):
        want = np.asarray(want) - 0.1
        assert want.max() > 0, k
        _assert_scaled_close(to["sum_of_squares"][k].numpy() - 0.1, want,
                             want, k)


def test_microbatches_match_the_full_batch_without_batch_norm():
    """Without batch norm the pixel-weighted accumulation over strided
    microbatches is the full-batch gradient."""
    net = get_model("simple_fcn")(device="cpu", batch_normalization=False,
                                  batchsize=4, **SMALL)
    net._optimizer = optimizers.SGD(1.0)
    batch = _batch(6, n=4)
    full, _, full_loss = net._train_step(net.variables, {}, batch)
    net.config["microbatch_size"] = 2
    micro, _, micro_loss = net._train_step(net.variables, {}, batch)
    np.testing.assert_allclose(float(micro_loss), float(full_loss),
                               rtol=1e-5)
    for k, before in net.variables.items():
        delta = full[k] - before
        _assert_scaled_close((micro[k] - before).numpy(), delta.numpy(),
                             delta.numpy(), k)
    net.config["microbatch_size"] = 3
    with pytest.raises(ValueError, match="must divide"):
        net._train_step(net.variables, {}, batch)


def test_microbatched_step_matches_jax_with_batch_norm(jax_nets):
    """Batch norm per microbatch (ghost batch norm), the moving statistics
    the mean of the microbatches' updates, as JAX's step."""
    config = {"microbatch_size": 2, "batchsize": 4}
    jnet = jax_nets("simple_fcn", **config)
    tnet, start = _twin(jnet, "simple_fcn", **config)
    _sgd(jnet, tnet)
    batch = _batch(7, n=4)
    jnew, _, jloss = jnet._train_step(jnet.variables, jnet.opt_state, batch,
                                      jax.random.PRNGKey(0))
    tnew, _, tloss = tnet._train_step(tnet.variables, tnet.opt_state, batch)
    _assert_step_matches(jnet, jnew, jloss, tnew, tloss, start)


@pytest.mark.parametrize("name,config", [
    ("simple_fcn", {}),
    ("bayesian_fcn", {"dropout_rate": 0.5}),
])
def test_remat_matches_plain(name, config):
    """remat recomputes the forward in the backward pass; with dropout the
    recompute must draw the forward's masks again (the generator is
    replayed), and the generator ends where the plain step leaves it."""
    results = {}
    for remat in (False, True):
        net = get_model(name)(device="cpu", learning_rate=0.01, seed=5,
                              remat=remat, **SMALL, **config)
        new, _, loss = net._train_step(net.variables, net.opt_state,
                                       _batch(8))
        results[remat] = (new, loss, net._generator.get_state())
    (plain, plain_loss, plain_gen), (remat, remat_loss, remat_gen) = (
        results[False], results[True])
    np.testing.assert_allclose(float(remat_loss), float(plain_loss),
                               rtol=1e-6)
    for k in plain:
        np.testing.assert_allclose(remat[k].numpy(), plain[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert torch.equal(remat_gen, plain_gen)


# -------------------------------------------------------------------- fit
def test_fit_trains_what_trains_and_nothing_else():
    net = get_model("simple_fcn")(device="cpu", train_encoder=False,
                                  batchsize=2, learning_rate=0.01, **SMALL)
    before = {k: v.clone() for k, v in net.variables.items()}
    net.fit(_batch(9, n=4), 2, output=False)
    assert net.global_step == 2
    assert int(net.opt_state["count"]) == 2
    for k, v in net.variables.items():
        moved = not torch.equal(v, before[k])
        assert moved == (k.endswith(("gamma", "beta", "moving_mean",
                                     "moving_variance"))), k


def test_fit_is_reproducible_from_seed():
    """Two fits with the same seed give bit-equal variables: the batch
    order derives from the seed."""
    def run():
        net = get_model("simple_fcn")(device="cpu", seed=11, batchsize=2,
                                      learning_rate=0.01, **SMALL)
        net.fit(_batch(10, n=6), 4, output=False)
        return net.variables
    a, b = run(), run()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bf16_training_converges_like_float32():
    """bfloat16 convolutions with float32 batch statistics train as
    float32 does (the JAX package's test at 80 steps)."""
    data = _blocks(0, 8)
    tails = {}
    for dtype in ("float32", "bfloat16"):
        net = get_model("simple_fcn")(device="cpu", seed=7, batchsize=2,
                                      learning_rate=0.01,
                                      compute_dtype=dtype, **SMALL)
        batches = data_io.training_batches(data, 2, seed=7)
        v, o, losses = net.variables, net.opt_state, []
        for _ in range(80):
            v, o, loss = net._train_step(v, o, next(batches))
            losses.append(float(loss))
        head, tail = np.mean(losses[:10]), np.mean(losses[-20:])
        assert np.isfinite(losses).all()
        assert tail < 0.8 * head, (dtype, head, tail)
        tails[dtype] = tail
    assert abs(tails["float32"] - tails["bfloat16"]) < 0.15, tails


def test_device_augmentation_is_refused():
    """An augmentation the on-device op set does not have is refused, as
    JAX's ``augment_sample`` refuses it (the ported ones are held against
    JAX's in tests/test_torch_device_augment.py)."""
    net = get_model("simple_fcn")(device="cpu", batchsize=2,
                                  device_augmentation={"flip": True},
                                  **SMALL)
    with pytest.raises(TypeError, match="flip"):
        net.fit(_batch(11), 1, output=False)


def test_fusion_models_refuse_fit():
    net = get_model("average_fusion")(
        data_description=({"rgb": np.float32, "depth": np.float32},
                          {"rgb": (None, None, 3), "depth": (None, None, 1),
                           "labels": (None, None)}, NUM_CLASSES),
        num_units=4, channel_factor=0.125, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"}, device="cpu")
    assert net.opt_state is None
    with pytest.raises(UserWarning, match="does not support training"):
        net.fit(_batch(12), 1)


def test_int8_model_serves_its_trained_weights():
    """quantize_for_serving, then fit: predict serves the trained kernels
    (the int8 form kept beside each kernel is made anew for a new
    kernel), as a fresh model with the trained variables and the same
    scales does."""
    data = _batch(13, n=2)
    net = get_model("simple_fcn")(device="cpu", batchsize=2,
                                  learning_rate=0.01, **SMALL)
    scales = net.quantize_for_serving(data, num_batches=1)
    assert scales
    served_before = net.predict(data, output_attr="prob")
    net.fit(data, 1, output=False)
    fresh = get_model("simple_fcn")(device="cpu", batchsize=2, **SMALL)
    fresh.variables = {k: v.clone() for k, v in net.variables.items()}
    fresh.quantize_for_serving(scales)
    served = net.predict(data, output_attr="prob")
    np.testing.assert_array_equal(served, fresh.predict(data,
                                                        output_attr="prob"))
    assert not np.array_equal(served, served_before)


def test_int8_serving_with_batch_norm_matches_jax(jax_nets):
    """The int8 branch of conv2d followed by batch norm (the BN variables
    sit under the conv's name, not under it twice): the same scales as
    JAX's and labels equal to JAX's but for at most 2% of pixels, each a
    near tie of the port's probabilities (within 2**-5 relative)."""
    jnet = jax_nets("simple_fcn", seed=3)
    tnet, _ = _twin(jnet, "simple_fcn", seed=3)
    frames = _batch(17, n=2)
    want_scales = jnet.quantize_for_serving(frames, num_batches=2,
                                            min_channels=16)
    scales = tnet.quantize_for_serving(frames, num_batches=2,
                                       min_channels=16)
    assert set(scales) == set(want_scales) and scales
    for key, value in want_scales.items():
        np.testing.assert_allclose(scales[key], value, rtol=1e-5)
    want = jnet.predict(frames)
    prob = tnet.predict(frames, output_attr="prob")
    got = tnet.predict(frames)
    differ = got != want
    assert differ.mean() <= 0.02
    own = np.take_along_axis(prob[differ], got[differ][:, None], 1)
    other = np.take_along_axis(prob[differ], want[differ][:, None], 1)
    assert np.all(own - other <= 2.0 ** -5 * own)


# ------------------------------------------------------------------- data
def test_training_batches_order_matches_jax():
    data = _batch(14, n=5)
    want = jax_data_io.training_batches(data, 2, seed=3)
    got = data_io.training_batches(data, 2, seed=3)
    for _ in range(8):  # three epochs and a bit, partial batches too
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_training_batches_of_a_source_and_an_iterator():
    """A data source's own ``batches`` is asked for a shuffled, repeated
    stream with the fit's seed and its worker pool (none unless given); an
    iterator of batches is taken as it comes."""
    calls = []

    class Source:
        def batches(self, batchsize, **kwargs):
            calls.append((batchsize, kwargs))
            return iter(["batch"])
    assert list(data_io.training_batches(Source(), 3, seed=4)) == ["batch"]
    assert calls == [(3, {"shuffle": True, "repeat": True, "seed": 4,
                          "workers": None})]
    assert list(data_io.training_batches(Source(), 3, seed=4,
                                         workers=2)) == ["batch"]
    assert calls[-1][1]["workers"] == 2
    given = [{"rgb": np.zeros((1, 2, 2, 3), np.float32)}] * 2
    assert list(data_io.training_batches(iter(given), 1, seed=0)) == given


def test_iterate_batches_matches_jax():
    """Every batch padded to the batch size, the pad labelled -1, as
    JAX's ``iterate_batches(..., pad=True)``."""
    data = _batch(15, n=5)
    want = list(jax_data_io.iterate_batches(data, 2, pad=True))
    got = list(data_io.iterate_batches(data, 2))
    assert [v for _, v in got] == [v for _, v in want] == [2, 2, 1]
    for (a, _), (b, _) in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
