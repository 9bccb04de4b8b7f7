"""The Bayes, Dirichlet and Average fusions with AdapNet experts, in the
port against the JAX package's, on the CPU.

32x48 frames, ``num_units`` 4, 5 classes, JAX variables carried across
with ``from_jax_variables`` and the experts' BN moving statistics drawn at
random (eval-mode BN as a non-trivial affine map). Fused labels must be
equal where they are not near ties: a label may differ only where the
port's own scores of the two labels are within 1e-5 relative (for Bayes:
only where an expert's classification differs, itself at such a tie of
its probabilities). Expert probabilities within 1e-4: two 50-layer
float32 networks in eval mode, whose logits reach tens, part by up to
about 2e-5 in a probability (1e-5 holds for one expert at a time, in
tests/test_torch_adapnet.py, not for these weights). The Dirichlet
fused score (values up to a few hundred, the experts' saturated log
probabilities) within rtol 1e-5 and atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables

NUM_CLASSES = 5
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 4, "expert_model": "adapnet",
         "prefixes": {m: m for m in MODALITIES}, "batchsize": 2}
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, item 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed=0, n=2):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 32, 48, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, 32, 48)).astype(np.int32)}


def _pair(name, **config):
    """A JAX fusion model with AdapNet experts and the port's twin with
    the same variables (BN moving statistics drawn at random)."""
    jnet = jax_model(name)(data_description=DATA_DESCRIPTION, **SMALL,
                           **config)
    tnet = get_model(name)(data_description=DATA_DESCRIPTION, device="cpu",
                           **SMALL, **config)
    rng = np.random.RandomState(0)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    assert sorted(tnet.variables) == sorted(variables)
    for k, v in variables.items():
        if k.endswith("moving_mean"):
            variables[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            variables[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
    jnet.variables = {k: jnp.asarray(v) for k, v in variables.items()}
    tnet.variables = from_jax_variables(variables, device="cpu")
    return jnet, tnet


def _tie_gap(scores, labels, other):
    """Relative gap of ``scores`` between the two labels at each pixel."""
    a = np.take_along_axis(scores, labels[..., None].astype(int), -1)[..., 0]
    b = np.take_along_axis(scores, other[..., None].astype(int), -1)[..., 0]
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-30)


def _assert_labels_match(got, want, scores):
    assert got.dtype == np.int32 and got.shape == want.shape
    differ = got != want
    assert differ.mean() < 0.01
    assert np.all(_tie_gap(scores, got, want)[differ] <= TIE_RTOL)


def _assert_experts_match(jnet, tnet, data):
    for m in MODALITIES:
        got = tnet.predict(data, output_attr=f"{m}_prob")
        want = jnet.predict(data, output_attr=f"{m}_prob")
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        _assert_labels_match(
            tnet.predict(data, output_attr=f"{m}_classification"),
            jnet.predict(data, output_attr=f"{m}_classification"), got)


def test_bayes_with_adapnet_experts_matches_jax():
    rng = np.random.RandomState(1)
    cms = {m: rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
           + np.eye(NUM_CLASSES) * 200 for m in MODALITIES}
    jnet, tnet = _pair("bayes_mix", confusion_matrices=cms)
    data = _frames(2)
    _assert_experts_match(jnet, tnet, data)
    got, want = tnet.predict(data), jnet.predict(data)
    same_experts = np.all([
        tnet.predict(data, output_attr=f"{m}_classification")
        == jnet.predict(data, output_attr=f"{m}_classification")
        for m in MODALITIES], axis=0)
    np.testing.assert_array_equal(got[same_experts], want[same_experts])


def test_dirichlet_with_adapnet_experts_matches_jax():
    """The plain path (JAX's without its Pallas kernel, as the port's)."""
    rng = np.random.RandomState(2)
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    jnet, tnet = _pair("dirichlet_mix", dirichlet_params=params)
    data = _frames(3)
    _assert_experts_match(jnet, tnet, data)
    scores = tnet.predict(data, output_attr="fused_score")
    np.testing.assert_allclose(
        scores, jnet.predict(data, output_attr="fused_score"), atol=1e-4,
        rtol=1e-5)
    _assert_labels_match(tnet.predict(data), jnet.predict(data), scores)


def test_average_with_adapnet_experts_matches_jax():
    jnet, tnet = _pair("average_fusion")
    data = _frames(4)
    scores = tnet.predict(data, output_attr="fused_score")
    np.testing.assert_allclose(
        scores, jnet.predict(data, output_attr="fused_score"), atol=1e-5,
        rtol=0)
    _assert_labels_match(tnet.predict(data), jnet.predict(data), scores)
