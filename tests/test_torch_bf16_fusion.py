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


@pytest.fixture(scope="module")
def outputs():
    """Per frame: (JAX's outputs, {fusion: the port's outputs}), numpy,
    bfloat16 values as float32."""
    cms, params = _fusion_config()
    jnet = jax_model("average")(data_description=DATA_DESCRIPTION, **SMALL)
    variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    nets = {}
    for name, extra in (("average", {}),
                        ("bayes_mix", {"confusion_matrices": cms}),
                        ("dirichlet_mix", {"dirichlet_params": params})):
        nets[name] = get_model(name)(data_description=DATA_DESCRIPTION,
                                     device="cpu", **SMALL, **extra)
        nets[name].variables = variables
    prior = np.asarray(params["class_counts"], np.float32)
    prior = prior / (1e-20 + prior.sum())
    rng = np.random.RandomState(0)
    data = {"rgb": (rng.rand(2, 64, 96, 3) * 255).astype(np.float32),
            "depth": rng.rand(2, 64, 96, 1).astype(np.float32) * 10}
    frames = []
    for i in range(2):
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
        got = {}
        for name, net in nets.items():
            out = net._forward(net._batch_to_device(frame))
            got[name] = {k: v.float().numpy() if v.is_floating_point()
                         else v.numpy() for k, v in out.items()}
        frames.append((want, got))
    return frames


def _gaps(scores, port_labels, jax_labels):
    """The port's score of its own label minus that of JAX's label, and
    the former, where the two labels differ."""
    differ = port_labels != jax_labels
    own = np.take_along_axis(scores[differ], port_labels[differ][:, None],
                             1)[:, 0]
    other = np.take_along_axis(scores[differ], jax_labels[differ][:, None],
                               1)[:, 0]
    return differ, own - other, np.abs(own)


@pytest.mark.parametrize("modality", MODALITIES)
def test_bf16_expert_classifications_match_jax(outputs, modality):
    for want, got in outputs:
        port = got["average"]
        assert port[f"{modality}_classification"].dtype == np.int32
        differ, gap, own = _gaps(port[f"{modality}_prob"],
                                 port[f"{modality}_classification"],
                                 want[f"{modality}_classification"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= PROB_TIE * own)


def test_bf16_average_labels_match_jax(outputs):
    for want, got in outputs:
        port = got["average"]
        differ, gap, own = _gaps(port["fused_score"], port["prediction"],
                                 want["prediction"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= PROB_TIE * own)


def test_bf16_bayes_labels_match_jax(outputs):
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


def test_bf16_dirichlet_labels_match_jax(outputs):
    for want, got in outputs:
        port = got["dirichlet_mix"]
        differ, gap, own = _gaps(port["fused_score"], port["prediction"],
                                 want["dirichlet_mix"])
        assert differ.mean() <= MAX_SHARE
        assert np.all(gap <= DIRICHLET_TIE * own)
