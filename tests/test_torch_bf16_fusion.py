"""The served bfloat16 path against the JAX package's bfloat16 path, on the
CPU: the experts' classifications, then the Bayes, Dirichlet and Average
fused labels.

SMALL size: 2 frames of 64x96, ``num_units=8``, ``channel_factor=0.25``,
14 classes, JAX weights carried across. One JAX AverageFusion model in
bfloat16 gives JAX's expert outputs and Average labels; JAX's Bayes and
Dirichlet labels are its ``fusion_math`` on those outputs, as its
BayesFusion and DirichletFusion compute them.

The two packages round to bfloat16 at different places (8 significant
bits: a step is up to 2**-8 relative), so labels may differ. The test
bounds the share that differs (2% per fusion and expert) and requires
every difference to be a near tie of the port's own scores: expert
probabilities and Average scores within 2**-5 relative; Dirichlet log
scores (of order 50, sums of 28 products with logs of bf16
probabilities) within 2**-7 relative; a Bayes label may differ only where
an expert's classification does.

The same with AdapNet experts (ADAPNET, the config of
tests/test_torch_adapnet_fusion.py, with random BN moving statistics):
their classifications and the Bayes labels under the rules above. Through
AdapNet's 50 layers each package's bfloat16 outputs lie 0.4-1.2% of a
layer's largest value from float32, and as far from each other (no cast
point differs; eval-mode BN computes in float32 in both), so fused
Average and Dirichlet scores part by more than the ties above. A label of
theirs may differ only where the port's scores of the two labels lie
closer than the two packages' own bfloat16 errors at that pixel
(``_assert_rounding_ties``), at most 2% of a frame.
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

NUM_CLASSES = 14
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 8, "channel_factor": 0.25, "expert_model": "fcn",
         "batchsize": 1, "prefixes": {m: m for m in MODALITIES},
         "compute_dtype": "bfloat16"}
# AdapNet experts (their eval-mode BN's casts on the path), as
# tests/test_torch_adapnet_fusion.py builds them, in bfloat16
ADAPNET = {"num_units": 4, "expert_model": "adapnet", "batchsize": 1,
           "prefixes": {m: m for m in MODALITIES},
           "compute_dtype": "bfloat16"}
ADAPNET_CLASSES = 5
MAX_SHARE = 0.02
PROB_TIE = 2.0 ** -5
DIRICHLET_TIE = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fusion_config():
    rng = np.random.RandomState(2)
    cms = {m: rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
           + np.eye(NUM_CLASSES) * 200 for m in MODALITIES}
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    return cms, params


def _outputs(description, config, cms, params, data, num_classes,
             variables_hook=None):
    """Per frame: (JAX's outputs, {fusion: the port's outputs}), numpy,
    bfloat16 values as float32. One JAX AverageFusion of ``config`` gives
    JAX's expert outputs and Average labels; JAX's Bayes and Dirichlet
    labels (and its Dirichlet score, 'dirichlet_score') are its
    ``fusion_math`` on those outputs. The port's outputs of the same
    fusions in float32 are there too, as '<fusion>_float32'.
    ``variables_hook(variables)`` may change the variables (as numpy)
    that both packages then use."""
    jnet = jax_model("average")(data_description=description, **config)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    if variables_hook is not None:
        variables_hook(variables)
        jnet.variables = {k: jnp.asarray(v) for k, v in variables.items()}
    variables = from_jax_variables(variables, device="cpu")
    nets = {}
    for name, extra in (("average", {}),
                        ("bayes_mix", {"confusion_matrices": cms}),
                        ("dirichlet_mix", {"dirichlet_params": params})):
        for key, dtype in ((name, config["compute_dtype"]),
                           (f"{name}_float32", "float32")):
            nets[key] = get_model(name)(
                data_description=description, device="cpu",
                **dict(config, compute_dtype=dtype), **extra)
            nets[key].variables = variables
    prior = np.asarray(params["class_counts"], np.float32)
    prior = prior / (1e-20 + prior.sum())
    frames = []
    for i in range(len(data["rgb"])):
        frame = {k: v[i:i + 1] for k, v in data.items()}
        jout = jnet._jit_eval_step(jnet.variables, frame, jnet._next_rng())
        classes = [jout[f"{m}_classification"] for m in MODALITIES]
        bayes = jfm.bayes_fusion(
            classes, [np.asarray(cms[m], np.float32).T for m in MODALITIES],
            "data")[0]
        probs = [jout[f"{m}_prob"] / jnp.sum(jout[f"{m}_prob"], axis=3,
                                             keepdims=True)
                 for m in MODALITIES]
        dirichlet = jfm.dirichlet_fusion(
            probs, [np.asarray(params[m], np.float32) for m in MODALITIES],
            prior)
        want = {k: np.asarray(v).astype(np.float32)
                if np.asarray(v).dtype != np.int32 else np.asarray(v)
                for k, v in jout.items()}
        want["bayes_mix"] = np.asarray(jnp.argmax(bayes, 3))
        want["dirichlet_mix"] = np.asarray(jnp.argmax(dirichlet, 3))
        want["dirichlet_score"] = np.asarray(dirichlet).astype(np.float32)
        got = {}
        for name, net in nets.items():
            out = net._forward(net._batch_to_device(frame))
            got[name] = {k: v.float().numpy() if v.is_floating_point()
                         else v.numpy() for k, v in out.items()}
        frames.append((want, got))
    assert all(want[f"{m}_prob"].shape[-1] == num_classes
               for want, _ in frames for m in MODALITIES)
    return frames


@pytest.fixture(scope="module")
def outputs():
    """The FCN experts' outputs (SMALL), two 64x96 frames."""
    cms, params = _fusion_config()
    rng = np.random.RandomState(0)
    data = {"rgb": (rng.rand(2, 64, 96, 3) * 255).astype(np.float32),
            "depth": rng.rand(2, 64, 96, 1).astype(np.float32) * 10}
    return _outputs(DATA_DESCRIPTION, SMALL, cms, params, data, NUM_CLASSES)


def _random_bn_statistics(variables):
    """Eval-mode BN as a non-trivial affine map: moving statistics drawn
    at random (as tests/test_torch_adapnet_fusion.py draws them)."""
    rng = np.random.RandomState(0)
    for k, v in variables.items():
        if k.endswith("moving_mean"):
            variables[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            variables[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def adapnet_outputs():
    """The AdapNet experts' outputs (ADAPNET: the config of
    tests/test_torch_adapnet_fusion.py in bfloat16), two 32x48 frames."""
    rng = np.random.RandomState(4)
    k = ADAPNET_CLASSES
    cms = {m: rng.randint(0, 40, (k, k)) + np.eye(k) * 200
           for m in MODALITIES}
    params = {m: rng.rand(k, k) * 4 + 0.5 for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 10000, k)
    data = {"rgb": (rng.rand(2, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(2, 32, 48, 1).astype(np.float32) * 10}
    description = DATA_DESCRIPTION[:2] + (k,)
    return _outputs(description, ADAPNET, cms, params, data, k,
                    variables_hook=_random_bn_statistics)


def _gaps(scores, port_labels, jax_labels):
    """The port's score of its own label minus that of JAX's label, and
    the former, where the two labels differ."""
    differ = port_labels != jax_labels
    own = np.take_along_axis(scores[differ], port_labels[differ][:, None],
                             1)[:, 0]
    other = np.take_along_axis(scores[differ], jax_labels[differ][:, None],
                               1)[:, 0]
    return differ, own - other, np.abs(own)


def _assert_expert_classifications(outputs, modality):
    for want, got in outputs:
        port = got["average"]
        assert port[f"{modality}_classification"].dtype == np.int32
        differ, gap, own = _gaps(port[f"{modality}_prob"],
                                 port[f"{modality}_classification"],
                                 want[f"{modality}_classification"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= PROB_TIE * own)


def _assert_average_labels(outputs):
    for want, got in outputs:
        port = got["average"]
        differ, gap, own = _gaps(port["fused_score"], port["prediction"],
                                 want["prediction"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= PROB_TIE * own)


def _assert_bayes_labels(outputs):
    for want, got in outputs:
        labels = got["bayes_mix"]["prediction"]
        assert labels.dtype == np.int32
        differ = labels != want["bayes_mix"]
        assert differ.mean() <= MAX_SHARE
        expert_differs = np.zeros_like(differ)
        for m in MODALITIES:
            expert_differs |= (got["bayes_mix"][f"{m}_classification"]
                               != want[f"{m}_classification"])
        assert not (differ & ~expert_differs).any()


def _assert_dirichlet_labels(outputs):
    for want, got in outputs:
        port = got["dirichlet_mix"]
        differ, gap, own = _gaps(port["fused_score"], port["prediction"],
                                 want["dirichlet_mix"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= DIRICHLET_TIE * own)


def _assert_rounding_ties(outputs, fusion, jax_labels, jax_score):
    """A fused label may differ from JAX's only where the port's scores
    of the two labels lie closer than the two packages' own bfloat16
    errors at that pixel: the largest |bf16 score - float32 score| over
    the classes, of the port's and of JAX's (both against the port's
    float32 score, which equals JAX's within 1e-5, in
    tests/test_torch_adapnet_fusion.py)."""
    for want, got in outputs:
        port, f32 = got[fusion], got[f"{fusion}_float32"]["fused_score"]
        differ, gap, _ = _gaps(port["fused_score"], port["prediction"],
                               want[jax_labels])
        assert differ.mean() <= MAX_SHARE
        error = (np.abs(port["fused_score"] - f32).max(-1)
                 + np.abs(want[jax_score] - f32).max(-1))
        assert np.all(gap <= error[differ])


@pytest.mark.parametrize("modality", MODALITIES)
def test_bf16_expert_classifications_match_jax(outputs, modality):
    _assert_expert_classifications(outputs, modality)


def test_bf16_average_labels_match_jax(outputs):
    _assert_average_labels(outputs)


def test_bf16_bayes_labels_match_jax(outputs):
    _assert_bayes_labels(outputs)


def test_bf16_dirichlet_labels_match_jax(outputs):
    _assert_dirichlet_labels(outputs)


@pytest.mark.parametrize("modality", MODALITIES)
def test_bf16_adapnet_expert_classifications_match_jax(adapnet_outputs,
                                                       modality):
    _assert_expert_classifications(adapnet_outputs, modality)


def test_bf16_adapnet_average_labels_match_jax(adapnet_outputs):
    _assert_rounding_ties(adapnet_outputs, "average", "prediction",
                          "fused_score")


def test_bf16_adapnet_bayes_labels_match_jax(adapnet_outputs):
    _assert_bayes_labels(adapnet_outputs)


def test_bf16_adapnet_dirichlet_labels_match_jax(adapnet_outputs):
    _assert_rounding_ties(adapnet_outputs, "dirichlet_mix", "dirichlet_mix",
                          "dirichlet_score")
