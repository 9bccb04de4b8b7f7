"""The port's Dirichlet fit against the JAX package's, on the CPU: the four
host solvers of ``ops/dirichlet_estimation.py``, the device statistic
``fusion_math.dirichlet_sufficient_statistics`` and the whole
``DirichletFusion.fit`` at the reduced size of ``test_torch_fusion.py``
(``channel_factor=0.125``, ``num_units=4``, 6 classes, 32x48 frames).

Tolerances: the solvers get the same float64 inputs and run the same
float64 steps, rtol 1e-10; the statistic is a float32 sum in another
order, rtol 1e-5; the fitted parameters come from those sums through the
EM, rtol 1e-3; class counts exact; fused labels equal except at argmax
ties of the port's scores (relative gap 1e-5).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import dirichlet_estimation as jde
from modular_semantic_segmentation_tpu.ops import fusion_math as jfm
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import dirichlet_estimation as de
from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.ops.cuda import dirichlet

NUM_CLASSES = 6
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
         "prefixes": {"rgb": "rgb", "depth": "depth"}, "batchsize": 2}
MODALITIES = ("rgb", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed=0, n=3):
    """n frames with -1 labels; with batchsize 2 and n = 3 the second
    batch is padded."""
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 32, 48, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 48)).astype(np.int32)}


def _statistics(seed, k=5, n=400):
    """(ss, neg_ss, n) of Dirichlet samples, float64."""
    rng = np.random.RandomState(seed)
    pos = rng.dirichlet(rng.rand(k) * 3 + 0.5, size=n)
    neg = rng.dirichlet(np.ones(k), size=n)
    return np.log(pos).mean(0), np.log(neg).mean(0), n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("estimator", ["differentiation", "estimation",
                                       "fixedpoint", "meanprecision"])
def test_solvers_match_jax(estimator, seed):
    ss, neg_ss, n = _statistics(seed)
    init = np.ones(ss.shape[0])

    def run(module):
        if estimator == "differentiation":
            return module.find_dirichlet_priors(ss, neg_ss, init,
                                                max_iter=10000)
        if estimator == "estimation":
            return module.find_dirichlet_priors_alt(ss, init, max_iter=10000)
        fit = (module.fixedpoint_with_sufficient_statistic
               if estimator == "fixedpoint"
               else module.meanprecision_with_sufficient_statistic)
        return fit(ss, n, ss.shape[0], init, maxiter=2000)

    got, want = run(de), run(jde)
    assert got.dtype == np.float64 and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_sample_helpers_match_jax():
    rng = np.random.RandomState(2)
    a = rng.dirichlet([2.0, 1.0, 3.0], size=300)
    b = rng.dirichlet([1.0, 1.0, 1.0], size=200)
    np.testing.assert_allclose(de.sufficient_statistic_from_samples(a),
                               jde.sufficient_statistic_from_samples(a),
                               rtol=1e-10)
    alphas = np.array([2.0, 1.0, 3.0])
    np.testing.assert_allclose(de.dirichlet_loglikelihood(a, alphas),
                               jde.dirichlet_loglikelihood(a, alphas),
                               rtol=1e-10)
    ss = de.sufficient_statistic_from_samples(a)
    np.testing.assert_allclose(
        de.loglikelihood_from_statistic(ss, 300, alphas),
        jde.loglikelihood_from_statistic(ss, 300, alphas), rtol=1e-10)
    np.testing.assert_allclose(de.dirichlet_mle_from_samples(a),
                               jde.dirichlet_mle_from_samples(a),
                               rtol=1e-10)
    got = de.likelihood_ratio_test(a, b, maxiter=200)
    want = jde.likelihood_ratio_test(a, b, maxiter=200)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10)


def test_sufficient_statistics_match_jax():
    """Labels -1 and >= C count nowhere."""
    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(7), size=(2, 20, 30)).astype(np.float32)
    labels = rng.randint(-1, NUM_CLASSES + 2, (2, 20, 30)).astype(np.int32)
    ss, counts = fm.dirichlet_sufficient_statistics(
        torch.from_numpy(probs), torch.from_numpy(labels), NUM_CLASSES)
    jss, jcounts = jfm.dirichlet_sufficient_statistics(
        jnp.asarray(probs), jnp.asarray(labels), NUM_CLASSES)
    assert ss.dtype == counts.dtype == torch.float32
    assert ss.shape == (NUM_CLASSES, 7)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    valid = labels[(labels >= 0) & (labels < NUM_CLASSES)]
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(valid, minlength=NUM_CLASSES))


@pytest.fixture(scope="module")
def fitted():
    """A JAX DirichletFusion and the port's twin (same weights, the port
    serving through the kernel path, bfloat16), both fitted on the same
    frames; the port's model predicted once before its fit."""
    jnet = jax_model("dirichlet_mix")(data_description=DATA_DESCRIPTION,
                                      **SMALL)
    tnet = get_model("dirichlet_mix")(data_description=DATA_DESCRIPTION,
                                      device="cpu", use_pallas=True,
                                      compute_dtype="bfloat16", **SMALL)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    data = _frames()
    # serve once with stale parameters, which fills the kernel's tables
    rng = np.random.RandomState(9)
    tnet.dirichlet_params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) + 0.5
                             for m in MODALITIES}
    tnet.class_counts = np.ones(NUM_CLASSES, np.float32)
    stale = tnet.predict(data)
    assert tnet._tables
    jparams = jnet.fit(data)
    tparams = tnet.fit(data)
    return jnet, tnet, jparams, tparams, data, stale


def test_fit_matches_jax(fitted):
    jnet, tnet, jparams, tparams, data, _ = fitted
    assert sorted(tparams) == sorted(jparams)
    for m in MODALITIES:
        assert tparams[m].dtype == np.float32
        assert np.all(np.isfinite(tparams[m])) and np.all(tparams[m] > 0)
        np.testing.assert_allclose(tparams[m], jparams[m], rtol=1e-3)
    np.testing.assert_array_equal(tparams["class_counts"],
                                  jparams["class_counts"])
    labels = data["labels"]
    np.testing.assert_array_equal(
        tparams["class_counts"],
        np.bincount(labels[labels >= 0], minlength=NUM_CLASSES))


def test_stats_step_runs_float32_experts(fitted):
    """The statistics come from float32 experts although the model
    serves in bfloat16."""
    _, tnet, _, _, data, _ = fitted
    counts, _ = tnet._get_sufficient_statistic(data)
    tnet.compute_dtype = torch.float32
    try:
        probs = {m: tnet.predict(data, output_attr=f"{m}_prob")
                 for m in MODALITIES}
    finally:
        tnet.compute_dtype = torch.bfloat16
    labels = data["labels"]
    for m in MODALITIES:
        ss, _ = fm.dirichlet_sufficient_statistics(
            torch.from_numpy(probs[m]), torch.from_numpy(labels),
            NUM_CLASSES)
        np.testing.assert_allclose(counts[m], ss.numpy(), rtol=1e-5)


def test_predict_after_fit_matches_jax(fitted):
    """The port serves the fitted parameters through the kernel path (the
    plain version on the CPU), in float32 like the JAX model: labels equal
    JAX's except at argmax ties of the port's scores, and the model that
    served before its fit serves the new coefficients."""
    jnet, tnet, _, _, data, stale = fitted
    tnet.compute_dtype = torch.float32
    try:
        got = tnet.predict(data)
        probs = torch.stack([torch.from_numpy(tnet.predict(
            data, output_attr=f"{m}_norm_prob")).reshape(-1, NUM_CLASSES)
            for m in MODALITIES])
    finally:
        tnet.compute_dtype = torch.bfloat16
    want = jnet.predict(data)
    coeffs, bias = tnet._kernel_tables(NUM_CLASSES)
    fresh = dirichlet.dirichlet_tables(
        [tnet.dirichlet_params[m] for m in MODALITIES], tnet._prior(),
        tnet.config["sigma"], NUM_CLASSES)
    np.testing.assert_array_equal(coeffs.numpy(), fresh[0])
    np.testing.assert_array_equal(bias.numpy(), fresh[1])
    scores = dirichlet.dirichlet_scores_plain(probs, coeffs, bias)
    best = scores.max(-1).values
    flat_got = torch.from_numpy(got.reshape(-1)).long()
    flat_want = torch.from_numpy(want.reshape(-1)).long()
    differ = flat_got != flat_want
    gap = best - scores.gather(1, flat_want[:, None])[:, 0]
    assert bool((gap[differ] <= 1e-5 * best[differ].abs()).all())
    assert int(differ.sum()) <= 0.01 * differ.numel()
    assert not np.array_equal(got, stale)


def test_prediction_difference_matches_jax(fitted):
    """The per-branch diagnostics on the plain path in float32, against
    JAX's: labels equal (no ties met at this seed), fused score atol 1e-4
    (float32 lgamma and logs in two implementations), probabilities atol
    1e-5."""
    jnet, tnet, _, _, data, _ = fitted
    data = {k: v[:2] for k, v in data.items()}
    tnet.compute_dtype = torch.float32
    tnet.config["use_pallas"] = False
    try:
        got = tnet.prediction_difference(data)
    finally:
        tnet.compute_dtype = torch.bfloat16
        tnet.config["use_pallas"] = True
    want = jnet.prediction_difference(data)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["fused_label"], want["fused_label"])
    np.testing.assert_allclose(got["fused_score"], want["fused_score"],
                               atol=1e-4, rtol=0)
    for m in MODALITIES:
        np.testing.assert_allclose(got[f"{m}_prob"], want[f"{m}_prob"],
                                   atol=1e-5, rtol=0)


def test_fit_leaves_zero_count_classes_at_ones():
    net = get_model("dirichlet_fusion")(data_description=DATA_DESCRIPTION,
                                        device="cpu", **SMALL)
    counts = {m: -np.abs(np.random.RandomState(5).rand(
        NUM_CLASSES, NUM_CLASSES)) * 100 for m in MODALITIES}
    class_counts = np.array([50, 0, 40, 60, 0, 30], np.int64)
    for m in MODALITIES:
        counts[m][class_counts == 0] = 0.0
    net._fit_sufficient_statistic(counts, class_counts)
    for m in MODALITIES:
        np.testing.assert_array_equal(net.dirichlet_params[m][:, 1], 1.0)
        np.testing.assert_array_equal(net.dirichlet_params[m][:, 4], 1.0)
        assert np.all(net.dirichlet_params[m] > 0)
    with pytest.raises(ValueError, match="unknown estimator"):
        net.config["estimator"] = "no_such_solver"
        net._fit_sufficient_statistic(counts, class_counts)
