"""MC dropout and the uncertainty models of the port, on the CPU:
``layers.dropout``, the batched stochastic tails of VarianceFusion and
BayesianFCN, BayesianFCN and the ``UncertaintyModel`` methods against the
JAX package's.

SMALL size: 64x96 frames, ``num_units=8``, ``channel_factor=0.25``, 14
classes, JAX weights carried across. Tolerances: BayesianFCN at dropout 0,
labels exact except where JAX's mean probabilities tie within 1e-5
relative, probabilities and entropies allclose at rtol 1e-5, atol 1e-6,
variances (zero up to rounding by batch position) below 1e-6; at dropout
0.5 with 64 samples, the pixel-mean of the variance map within 10% of
JAX's (the two draw different masks from their seeds). Dropout's kept
share within 5 binomial standard deviations of 1 - rate; kept values
scaled by exactly 1/(1 - rate). The batched tails against N-loops fed
the same masks: allclose at rtol 1e-5, atol 1e-7 (the convolutions run
at another batch size). The ``UncertaintyModel`` methods, fed the same
collected arrays, give JAX's results exactly (the Dirichlet fit of
``prob_distribution`` within 1e-10 relative).
"""

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_torch.models import bayesian_fcn
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.models.simple_fcn import (
    decoder, encoder_head, encoder_tail)
from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.variables import Ctx

NUM_CLASSES = 14
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
BAYESIAN = {"prefix": "rgb", "modality": "rgb", "num_units": 8,
            "channel_factor": 0.25, "dropout_rate": 0.0, "num_samples": 3,
            "batchsize": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 64, 96, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 64, 96, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 64, 96)).astype(np.int32)}


@pytest.fixture(scope="module")
def bayesian():
    """JAX's BayesianFCN (batch norm on, moving statistics made up) and
    the port's twin with its weights."""
    jnet = jax_model("bayesian_fcn")(data_description=DATA_DESCRIPTION,
                                     **BAYESIAN)
    tnet = get_model("bayesian_fcn")(data_description=DATA_DESCRIPTION,
                                     device="cpu", **BAYESIAN)
    rng = np.random.RandomState(5)
    variables = {}
    for k, v in jnet.variables.items():
        v = np.asarray(v)
        if k.endswith(("moving_mean", "beta")):
            v = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k.endswith(("moving_variance", "gamma")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        variables[k] = v
    jnet.variables = {k: np.asarray(v) for k, v in variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    return jnet, tnet


# ---------------------------------------------------------------- dropout
def _ctx(seed=0):
    return Ctx({}, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rate", [0.2, 0.5, 0.8])
def test_dropout_keeps_a_binomial_share_scaled_exactly(rate):
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        0.5, 2.0, (4, 32, 32, 16)).astype(np.float32))
    out = ll.dropout(_ctx(), x, rate)
    kept = out != 0
    n, keep = x.numel(), 1.0 - rate
    sigma = np.sqrt(keep * (1 - keep) / n)
    assert abs(float(kept.float().mean()) - keep) < 5 * sigma
    want = x.numpy() / np.float32(keep)
    np.testing.assert_array_equal(out.numpy()[kept.numpy()],
                                  want[kept.numpy()])


def test_dropout_noise_shape_drops_whole_pixels():
    x = torch.ones((2, 16, 24, 8))
    out = ll.dropout(_ctx(), x, 0.3, noise_shape=(2, 16, 24, 1))
    kept = out != 0
    assert bool((kept == kept[..., :1]).all())
    assert 0 < float(kept.float().mean()) < 1


def test_dropout_is_seeded_and_off_at_rate_0():
    x = torch.ones((2, 8, 8, 4))
    assert torch.equal(ll.dropout(_ctx(3), x, 0.5),
                       ll.dropout(_ctx(3), x, 0.5))
    assert not torch.equal(ll.dropout(_ctx(3), x, 0.5),
                           ll.dropout(_ctx(4), x, 0.5))
    assert ll.dropout(Ctx({}), x, 0.0) is x
    assert ll.dropout(Ctx({}), x, 0.5, training=False) is x
    with pytest.raises(ValueError, match="generator"):
        ll.dropout(Ctx({}), x, 0.5)


class _ReplayedMasks:
    """Stands in for ``layers.dropout``: records the keep masks of a
    batched pass (numpy draws, in call order), then hands each sample of
    an N-loop its slice of them."""

    def __init__(self, batch):
        self.batch = batch
        self.masks = []
        self.sample = None
        self.call = 0

    def __call__(self, ctx, x, rate, training=True, noise_shape=None):
        keep = 1.0 - rate
        if self.sample is None:
            mask = np.random.RandomState(len(self.masks)).rand(
                *x.shape) < keep
            self.masks.append(mask)
        else:
            lo = self.sample * self.batch
            mask = self.masks[self.call % len(self.masks)][
                lo:lo + self.batch]
            self.call += 1
        return torch.where(torch.from_numpy(mask), x / keep,
                           torch.zeros_like(x))


def test_variance_fusion_batched_tail_equals_n_loop(monkeypatch):
    """The N stochastic tails as one tail at batch N*B compute, sample for
    sample, what N tails at batch B compute with the same masks."""
    net = get_model("variance")(
        data_description=DATA_DESCRIPTION, num_units=8, channel_factor=0.25,
        expert_model="fcn", prefixes={"rgb": "rgb"}, dropout_rate=0.5,
        num_samples=4, batchsize=2, device="cpu")
    batch = net._preprocess(net._batch_to_device(
        {k: v[:2] for k, v in _frames().items()}))
    masks = _ReplayedMasks(batch=2)
    monkeypatch.setattr(ll, "dropout", masks)
    with torch.inference_mode():
        ctx = Ctx(net.variables)
        pool3 = encoder_head(ctx, batch["rgb"], "rgb", batchnorm=False,
                             channel_factor=0.25)["pool3"]
        stacked = net._tail_prob(ctx, pool3.repeat(4, 1, 1, 1), "rgb", True)
        assert len(masks.masks) == 2  # after pool3 and pool4
        loop = []
        for i in range(4):
            masks.sample = i
            loop.append(net._tail_prob(ctx, pool3, "rgb", True))
    np.testing.assert_allclose(stacked.numpy(), torch.cat(loop).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_bayesian_fcn_batched_samples_equal_n_loop(bayesian, monkeypatch):
    """BayesianFCN's batch of N samples against an N-loop over the same
    masks at all five sites, through ``sampling_uncertainty``."""
    _, net = bayesian
    cfg = dict(net.config, dropout_rate=0.5, num_samples=4)
    batch = net._preprocess(net._batch_to_device(
        {k: v[:2] for k, v in _frames().items()}))
    masks = _ReplayedMasks(batch=2)
    monkeypatch.setattr(ll, "dropout", masks)
    monkeypatch.setattr(net, "config", cfg)
    with torch.inference_mode():
        ctx = Ctx(net.variables)
        out = net._test_outputs(ctx, batch)
        assert len(masks.masks) == 5
        head = encoder_head(ctx, batch["rgb"], "rgb", channel_factor=0.25)
        loop = []
        for i in range(4):
            masks.sample = i
            tail = encoder_tail(ctx, {"pool3": head["pool3"]}, "rgb", 8,
                                channel_factor=0.25, dropout_rate=0.5,
                                dropout_layers=cfg["dropout_layers"])
            dec = decoder(ctx, tail["fused"], "rgb", 8, NUM_CLASSES,
                          dropout_rate=0.5)
            loop.append(ll.softmax(dec["score"]))
        mean, uncertainties = bayesian_fcn.sampling_uncertainty(
            torch.stack(loop))
    np.testing.assert_allclose(out["prob"].numpy(), mean.numpy(),
                               rtol=1e-5, atol=1e-7)
    for key, value in uncertainties.items():
        np.testing.assert_allclose(out[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------- BayesianFCN
def test_bayesian_fcn_at_rate_0_matches_jax(bayesian):
    """Collected over 3 frames at batch size 2 (the last batch padded)."""
    jnet, tnet = bayesian
    keys = ["prediction", "prob", "entropy", "cond_entropy", "variance"]
    want = jnet._collect(_frames(), keys)
    got = tnet._collect(_frames(), keys)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["prediction"].dtype == np.int32
    differ = got["prediction"] != want["prediction"]
    prob = want["prob"][differ]
    best = np.take_along_axis(prob, want["prediction"][differ][:, None],
                              1)[:, 0]
    other = np.take_along_axis(prob, got["prediction"][differ][:, None],
                               1)[:, 0]
    assert np.all(best - other <= 1e-5 * best)
    for key in ("prob", "entropy", "cond_entropy"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6)
    assert np.abs(got["variance"]).max() < 1e-6
    assert np.abs(want["variance"]).max() < 1e-6


def test_bayesian_fcn_temperature_flattens(bayesian):
    _, tnet = bayesian
    frame = {k: v[:1] for k, v in _frames().items()}
    cold = tnet.predict(frame, output_attr="prob")
    tnet.config["temperature_scaling"] = 10.0
    try:
        hot = tnet.predict(frame, output_attr="prob")
    finally:
        tnet.config.pop("temperature_scaling")
    assert hot.max() < cold.max()


def test_bayesian_fcn_mc_statistics_match_jax(bayesian):
    jnet, tnet = bayesian
    frame = {k: v[:1] for k, v in _frames().items()}
    for net in bayesian:
        net.config.update(dropout_rate=0.5, num_samples=64)
    # the JAX step reads the config while tracing: trace it anew
    jnet._rejit_eval_step()
    try:
        want = np.asarray(jnet._jit_eval_step(
            jnet.variables, frame, jnet._next_rng())["variance"])
        got = tnet.predict(frame, output_attr="variance")
    finally:
        for net in bayesian:
            net.config.update(dropout_rate=0.0, num_samples=3)
        jnet._rejit_eval_step()
    assert np.isfinite(got).all() and got.min() >= 0
    assert want.mean() > 1e-3
    assert abs(got.mean() / want.mean() - 1) < 0.1


def test_bayesian_fcn_training_is_not_ported(bayesian):
    """BayesianFCN's training outputs, which the port once refused: in
    train mode at dropout 0 the masked cross-entropy of its stochastic
    pass equals JAX's (rtol 1e-5), and it records the moving-statistic
    updates of the same batch norms."""
    import jax
    from modular_semantic_segmentation_tpu.ops.variables import \
        Ctx as JaxCtx
    from modular_semantic_segmentation_torch.ops.losses import one_hot
    jnet, tnet = bayesian
    frames = _frames(n=2, seed=3)
    jctx = JaxCtx(dict(jnet.variables), train=True,
                  rng=jax.random.PRNGKey(0))
    want = jnet._train_outputs(jctx, {
        "rgb": frames["rgb"],
        "labels": jax.nn.one_hot(frames["labels"], NUM_CLASSES)})["loss"]
    tctx = Ctx(tnet.variables, train=True,
               generator=torch.Generator().manual_seed(0))
    got = tnet._train_outputs(tctx, {
        "rgb": torch.from_numpy(frames["rgb"]),
        "labels": one_hot(torch.from_numpy(frames["labels"]),
                          NUM_CLASSES)})["loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert sorted(tctx.updates) == sorted(jctx.updates)


# ------------------------------------------------------ UncertaintyModel
def _collected():
    """Arrays as ``_collect`` returns them, with void labels."""
    rng = np.random.RandomState(7)
    logits = rng.randn(2, 16, 24, NUM_CLASSES).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(-1, NUM_CLASSES, (2, 16, 24)).astype(np.int32)
    prediction = np.where(rng.rand(2, 16, 24) < 0.7, labels,
                          prob.argmax(-1)).clip(0).astype(np.int32)
    entropy = np.round(-(prob * np.log(prob)).sum(-1), 2)  # with ties
    return {"prediction": prediction, "prob": prob, "entropy": entropy,
            "labels": labels}


def _methods(net):
    return {
        "misclassification": lambda: net.misclassification_detection_score(
            None, "entropy"),
        "ood": lambda: net.out_of_distribution_detection_score(
            None, "entropy"),
        "nll": lambda: net.nll_score(None),
        "values": lambda: net.value_distribution(None, "entropy", bins=20),
        "mean_diff": lambda: net.mean_diff(
            None, np.full(NUM_CLASSES, 1.0 / NUM_CLASSES),
            condition=lambda labels, classes: labels % 2 == 0),
        "prob_distribution": lambda: net.prob_distribution(None,
                                                           max_samples=300),
    }


@pytest.mark.parametrize("method", sorted(_methods(None)))
def test_uncertainty_model_methods_match_jax(bayesian, monkeypatch, method):
    collected = _collected()
    if method == "ood":
        collected["labels"] = (collected["labels"] % 3) - 1  # -1, 0, 1
    for net in bayesian:
        monkeypatch.setattr(net, "_collect",
                            lambda data, keys: dict(collected))
    want, got = (_methods(net)[method]() for net in bayesian)
    if method == "prob_distribution":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-10)
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(got)], [want[k]
                                                    for k in sorted(want)]
    elif not isinstance(want, tuple):
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_uncertainty_model_one_class_gives_nan_as_jax(bayesian,
                                                      monkeypatch):
    """No misclassified pixel: NaN rates and area, with a warning."""
    collected = _collected()
    collected["prediction"] = collected["labels"].clip(0)
    results = []
    for net in bayesian:
        monkeypatch.setattr(net, "_collect",
                            lambda data, keys: dict(collected))
        with pytest.warns(UserWarning, match="one class"):
            results.append(net.misclassification_detection_score(
                None, "entropy"))
    want, got = results
    assert np.isnan(got[2]) and np.isnan(want[2])
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
