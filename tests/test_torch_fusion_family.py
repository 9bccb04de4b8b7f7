"""The port's Average, Variance and Uncertainty-Dirichlet fusion models, and
their fusion math, against the JAX package's, on the CPU.

SMALL size: 2 frames of 64x96, ``num_units=8``, 14 classes,
``channel_factor=0.25``; VarianceFusion at full width, because the JAX
model builds its experts at width 1.0 whatever ``channel_factor`` says.
JAX weights are carried across with ``params.from_jax_variables``; the
Uncertainty-Dirichlet parameters are the ones the JAX model fits.

Tolerances: labels exact, except where JAX's fused scores of the two
labels tie within 1e-5 relative; probabilities, variances and the
Average and Variance fused scores allclose at rtol 1e-5, atol 1e-6
(float32 convolutions in two implementations); the Dirichlet log scores
(of order 10 to 100), from the models and from the fusion math on given
inputs, at rtol 1e-5, atol 1e-4: they are differences of float32 lgamma
sums of order 100, and each package's lies up to 6e-5 from a float64
evaluation of the same formula; the variance fusion math on given inputs
at rtol 1e-5, atol 1e-6. At dropout 0.5 with 64 samples the two packages
draw different masks from their seeds, so the variance maps agree in
distribution, not pixel for pixel: the pixel-mean of each expert's map
within 10% of JAX's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import fusion_math as jfm
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import fusion_math as tfm

NUM_CLASSES = 14
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
FUSION = {"num_units": 8, "expert_model": "fcn", "batchsize": 1,
          "prefixes": {m: m for m in MODALITIES}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n=2):
    rng = np.random.RandomState(0)
    return {"rgb": (rng.rand(n, 64, 96, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 64, 96, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 64, 96)).astype(np.int32)}


def _pair(name, **config):
    """A JAX model and the port's twin with the same weights."""
    jnet = jax_model(name)(data_description=DATA_DESCRIPTION, **config)
    tnet = get_model(name)(data_description=DATA_DESCRIPTION, device="cpu",
                           **config)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    return jnet, tnet


def _outputs(jnet, tnet, frame):
    """All test outputs of one batch from each package, as numpy."""
    jout = jnet._jit_eval_step(jnet.variables, frame, jnet._next_rng())
    tout = tnet._forward(tnet._batch_to_device(frame))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def assert_labels_match(jax_labels, port_labels, jax_scores, rtol=1e-5):
    """Equal labels, except where JAX's scores of the two tie."""
    assert port_labels.dtype == np.int32
    differ = jax_labels != port_labels
    scores = jax_scores[differ]
    best = np.take_along_axis(scores, jax_labels[differ][:, None], 1)[:, 0]
    other = np.take_along_axis(scores, port_labels[differ][:, None], 1)[:, 0]
    assert np.all(best - other <= rtol * np.abs(best))
    assert differ.mean() < 0.01


@pytest.fixture(scope="module")
def average():
    return _pair("average", channel_factor=0.25, **FUSION)


@pytest.fixture(scope="module")
def variance():
    return _pair("variance", dropout_rate=0.0, num_samples=3, **FUSION)


@pytest.fixture(scope="module")
def uncertainty():
    """The JAX model fits its Dirichlet parameters on the frames; the
    port's twin is given them."""
    jnet, tnet = _pair("uncertainty_dirichlet_mix", channel_factor=0.25,
                       dropout_rate=0.0, num_samples=2, **FUSION)
    params = jnet.fit(_frames())
    tnet.dirichlet_params = {m: np.asarray(params[m], np.float32)
                             for m in MODALITIES}
    tnet.class_counts = np.asarray(params["class_counts"], np.float32)
    return jnet, tnet


def test_variance_fusion_math_matches_jax():
    rng = np.random.RandomState(1)
    probs = rng.dirichlet(np.ones(NUM_CLASSES), size=(2, 3, 8, 12)).astype(
        np.float32)
    variances = (rng.rand(2, 3, 8, 12, 1) * 1e-3).astype(np.float32)
    variances[0, 0, :2] = 0.0
    want = np.asarray(jfm.variance_fusion(jnp.asarray(probs),
                                          jnp.asarray(variances)))
    got = tfm.variance_fusion(torch.from_numpy(probs),
                              torch.from_numpy(variances)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 0.3])
def test_dirichlet_uncertainty_fusion_math_matches_jax(sigma):
    """Mixes outside [0, 1] are clipped, 0 and 1 included."""
    rng = np.random.RandomState(2)
    probs = [rng.dirichlet(np.ones(NUM_CLASSES), size=(2, 8, 12)).astype(
        np.float32) for _ in MODALITIES]
    alphas = [rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for _ in MODALITIES]
    mixes = [rng.uniform(-0.2, 1.2, (2, 8, 12)).astype(np.float32)
             for _ in MODALITIES]
    mixes[0][0, 0, :2] = (0.0, 1.0)
    prior = rng.dirichlet(np.ones(NUM_CLASSES))
    want = np.asarray(jfm.dirichlet_uncertainty_fusion(
        [jnp.asarray(p) for p in probs], alphas,
        [jnp.asarray(m) for m in mixes], prior, sigma=sigma))
    got = tfm.dirichlet_uncertainty_fusion(
        [torch.from_numpy(p) for p in probs], alphas,
        [torch.from_numpy(m) for m in mixes], prior, sigma=sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_average_fusion_matches_jax(average):
    jnet, tnet = average
    data = _frames()
    for i in range(2):
        jout, tout = _outputs(jnet, tnet, {k: v[i:i + 1]
                                           for k, v in data.items()})
        assert_labels_match(jout["prediction"], tout["prediction"],
                            jout["fused_score"])
        for key in ("fused_score", "rgb_prob", "depth_prob"):
            np.testing.assert_allclose(tout[key], jout[key], rtol=1e-5,
                                       atol=1e-6)


def test_variance_fusion_at_rate_0_matches_jax(variance):
    """At dropout 0 both take the exact zero-variance branch."""
    jnet, tnet = variance
    data = _frames()
    for i in range(2):
        jout, tout = _outputs(jnet, tnet, {k: v[i:i + 1]
                                           for k, v in data.items()})
        assert_labels_match(jout["prediction"], tout["prediction"],
                            jout["fused_score"])
        for m in MODALITIES:
            assert not tout[f"{m}_variance"].any()
            assert tout[f"{m}_variance"].shape == jout[f"{m}_variance"].shape
        for key in ("fused_score", "rgb_prob", "depth_prob"):
            np.testing.assert_allclose(tout[key], jout[key], rtol=1e-5,
                                       atol=1e-6)


def test_variance_fusion_mc_statistics_match_jax(variance):
    jnet, tnet = variance
    frame = {k: v[:1] for k, v in _frames().items()}
    for net in variance:
        net.config.update(dropout_rate=0.5, num_samples=64)
    # the JAX step reads the config while tracing: trace it anew
    jnet._rejit_eval_step()
    try:
        jout, tout = _outputs(jnet, tnet, frame)
    finally:
        for net in variance:
            net.config.update(dropout_rate=0.0, num_samples=3)
        jnet._rejit_eval_step()
    for m in MODALITIES:
        got, want = tout[f"{m}_variance"], jout[f"{m}_variance"]
        assert np.isfinite(got).all() and got.min() >= 0
        assert want.mean() > 1e-6
        assert abs(got.mean() / want.mean() - 1) < 0.1
    # the fused score is the inverse-variance weighting of what it reports
    certainties = 1.0 / (1e-20 + np.stack([tout[f"{m}_variance"]
                                           for m in MODALITIES]))
    probs = np.stack([tout[f"{m}_prob"] for m in MODALITIES])
    np.testing.assert_allclose(
        tout["fused_score"],
        (certainties * probs).sum(0) / certainties.sum(0), rtol=1e-4,
        atol=1e-5)


def test_uncertainty_dirichlet_at_rate_0_matches_jax(uncertainty):
    """At dropout 0 every sample is the clean pass: the variance, and so
    the mix, is zero, and the fusion is plain Dirichlet fusion."""
    jnet, tnet = uncertainty
    data = _frames()
    for i in range(2):
        jout, tout = _outputs(jnet, tnet, {k: v[i:i + 1]
                                           for k, v in data.items()})
        assert_labels_match(jout["prediction"], tout["prediction"],
                            jout["fused_score"])
        np.testing.assert_allclose(tout["fused_score"], jout["fused_score"],
                                   rtol=1e-5, atol=1e-4)
        for m in MODALITIES:
            assert not tout[f"{m}_uncertainty"].any()
            np.testing.assert_allclose(tout[f"{m}_prob"], jout[f"{m}_prob"],
                                       rtol=1e-5, atol=1e-6)


def test_uncertainty_dirichlet_above_rate_0_and_unfitted():
    """Above rate 0 the mix is the mean variance over its global maximum,
    in (0, 1]; without parameters the model predicts zeros, as JAX's."""
    config = dict(channel_factor=0.25, dropout_rate=0.3, num_samples=3,
                  **FUSION)
    tnet = get_model("uncertainty_dirichlet_mix")(
        data_description=DATA_DESCRIPTION, device="cpu", **config)
    frame = {k: v[:1] for k, v in _frames().items()}
    out = tnet._forward(tnet._batch_to_device(frame))
    assert out["prediction"].dtype == torch.int32
    assert not out["prediction"].any() and not out["fused_score"].any()
    assert tuple(out["fused_score"].shape) == (1, 64, 96, NUM_CLASSES)
    rng = np.random.RandomState(3)
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 1000, NUM_CLASSES)
    tnet = get_model("uncertainty_dirichlet_mix")(
        data_description=DATA_DESCRIPTION, device="cpu",
        dirichlet_params=params, **config)
    out = tnet._forward(tnet._batch_to_device(frame))
    for m in MODALITIES:
        mix = out[f"{m}_uncertainty"]
        assert 0 < float(mix.max()) <= 1.0
        assert float(mix.min()) >= 0
    assert torch.isfinite(out["fused_score"]).all()
