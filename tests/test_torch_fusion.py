"""The port's Bayes and Dirichlet fusion models against the JAX package's,
on the CPU, at reduced size (experts with ``channel_factor=0.125``,
``num_units=4``, 6 classes, 32x48 frames), JAX weights carried across.

Tolerances: fused ``prediction``, likelihoods, confusion matrices and
measures exact; expert probabilities allclose at atol 1e-5; the Dirichlet
fused score (values of order 10) allclose at atol 1e-4: float32 lgamma
and logs in two implementations.

The JAX package packs the two FCN stems into one block-diagonal stack by
default; the port runs them unpacked. The JAX models here keep that
default.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops.pallas import dirichlet_kernel
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops.cuda import dirichlet

NUM_CLASSES = 6
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
         "prefixes": {"rgb": "rgb", "depth": "depth"}, "batchsize": 2}


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


def _frames(seed=0, n=3):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 32, 48, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 48)).astype(np.int32)}


def _confusion_matrices(seed=0):
    """Count-like matrices with zero entries, rows = true class."""
    rng = np.random.RandomState(seed)
    return {m: (rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
                * (rng.rand(NUM_CLASSES, NUM_CLASSES) > 0.3)
                + np.eye(NUM_CLASSES) * 200) for m in ("rgb", "depth")}


def _pair(name, **config):
    """A JAX model and the port's twin with the same weights."""
    jnet = jax_model(name)(data_description=DATA_DESCRIPTION, **SMALL,
                           **config)
    config.pop("use_pallas", None)
    tnet = get_model(name)(data_description=DATA_DESCRIPTION, device="cpu",
                           **SMALL, **config)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    tnet.variables = from_jax_variables(variables, device="cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def bayes():
    return _pair("bayes_mix", confusion_matrices=_confusion_matrices())


def _dirichlet_params(seed=1):
    rng = np.random.RandomState(seed)
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in ("rgb", "depth")}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    return params


@pytest.fixture(scope="module")
def dirichlet_pair():
    """JAX with use_pallas=False (its Pallas kernel needs a TPU outside
    interpret mode; tests/test_pallas_kernels.py holds the two equal) and
    the port's use_pallas=True model."""
    jnet, tnet = _pair("dirichlet_mix", dirichlet_params=_dirichlet_params())
    tnet.config["use_pallas"] = True
    return jnet, tnet


def test_bayes_fusion_matches_jax(bayes):
    jnet, tnet = bayes
    data = _frames()
    np.testing.assert_array_equal(tnet.predict(data), jnet.predict(data))
    np.testing.assert_allclose(tnet.predict(data, output_attr="fused_score"),
                               jnet.predict(data, output_attr="fused_score"),
                               atol=1e-5, rtol=0)
    for m in ("rgb", "depth"):
        np.testing.assert_array_equal(
            tnet.predict(data, output_attr=f"{m}_classification"),
            jnet.predict(data, output_attr=f"{m}_classification"))


def test_bayes_get_insight_matches_jax(bayes):
    jnet, tnet = bayes
    data = _frames(seed=1, n=2)
    want = jnet.get_insight(data)
    got = tnet.get_insight(data)
    for jprob, tprob in zip(want[0], got[0]):
        np.testing.assert_allclose(tprob, jprob, atol=1e-5, rtol=0)
    for part in (1, 2):
        for jv, tv in zip(want[part], got[part]):
            np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(got[3], want[3])


def test_bayes_score_matches_jax(bayes):
    jnet, tnet = bayes
    data = _frames(seed=2)
    jmeasures, jcm = jnet.score(data)
    tmeasures, tcm = tnet.score(data)
    np.testing.assert_array_equal(tcm, jcm)
    for key in jmeasures:
        np.testing.assert_array_equal(tmeasures[key], jmeasures[key])


def test_bayes_decision_matrix_matches_jax():
    jnet, tnet = _pair("bayes_mix", confusion_matrices=_confusion_matrices(3),
                       use_decision_matrix=True)
    data = _frames(seed=3)
    np.testing.assert_array_equal(tnet.predict(data), jnet.predict(data))


def test_dirichlet_kernel_path_matches_jax(dirichlet_pair):
    jnet, tnet = dirichlet_pair
    data = _frames(seed=4)
    dirichlet.KERNEL.launches = 0
    got = tnet.predict(data)
    assert dirichlet.KERNEL.launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(got, jnet.predict(data))
    # and against the JAX Pallas kernel (interpret mode) on JAX's
    # normalized expert probabilities
    probs = [jnp.asarray(jnet.predict(data, output_attr=f"{m}_norm_prob"))
             for m in ("rgb", "depth")]
    want = np.asarray(dirichlet_kernel.dirichlet_fusion_label(
        probs, [jnet.dirichlet_params[m] for m in ("rgb", "depth")],
        jnet._prior(), sigma=jnet.config["sigma"], tile=256,
        interpret=True))
    np.testing.assert_array_equal(got, want)


def test_dirichlet_plain_path_matches_jax(dirichlet_pair):
    jnet, tnet = dirichlet_pair
    data = _frames(seed=5, n=2)
    tnet.config["use_pallas"] = False
    try:
        np.testing.assert_array_equal(tnet.predict(data), jnet.predict(data))
        np.testing.assert_allclose(
            tnet.predict(data, output_attr="fused_score"),
            jnet.predict(data, output_attr="fused_score"), atol=1e-4,
            rtol=0)
        np.testing.assert_allclose(
            tnet.predict(data, output_attr="rgb_norm_prob"),
            jnet.predict(data, output_attr="rgb_norm_prob"), atol=1e-5,
            rtol=0)
    finally:
        tnet.config["use_pallas"] = True


def test_dirichlet_measurement_phase_predicts_zeros():
    net = get_model("dirichlet_fusion")(data_description=DATA_DESCRIPTION,
                                        device="cpu", **SMALL)
    data = _frames(seed=6, n=2)
    assert net.dirichlet_params is None
    np.testing.assert_array_equal(net.predict(data), 0)
    score = net.predict(data, output_attr="fused_score")
    assert score.shape == (2, 32, 48, NUM_CLASSES) and not score.any()


def test_registry_matches_jax_names():
    for name in ("fcn", "simple_fcn", "bayes_mix", "bayes_fusion",
                 "dirichlet_mix", "dirichlet_fusion", "adapnet",
                 "fusion_fcn", "progressive_fcn"):
        assert get_model(name).__name__ == jax_model(name).__name__
    with pytest.raises(UserWarning, match="not found"):
        get_model("no_such_model")
