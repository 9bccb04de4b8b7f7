"""int8 serving of fusions with AdapNet experts, the port against the JAX
package, on the CPU in float32.

One JAX Average fusion of two AdapNet experts (``num_units`` 4, 5
classes, BN moving statistics drawn at random), its variables carried
into the port's Average, Bayes and Dirichlet fusions. 2 frames of 64x48
(3,072 input positions): with AdapNet's floor of 2048 input positions
(``FusionModel.ptq_min_pixels``) and ``min_channels`` 16, only each
expert's ``block_0_2`` (64 channels in, at the full frame) goes int8;
every later conv lies at 192 positions or fewer and stays float. With the
floor at 0 the bottlenecks go int8 too, and both packages pick the same
126 convs.

Scales: the same keys as JAX's, values within rtol 1e-6. Labels: with
integer frames and the stem's first kernel rounded to multiples of 2**-8
(conv1_1's sums exact in float32 in any order, as
tests/test_torch_int8_serving.py arranges for Variance), both packages
serve JAX's scales; the port's labels equal those of JAX's model run op
by op, except at near ties of the port's own scores: probabilities and
Average scores within 2**-5 relative, Dirichlet log scores within 2**-7,
a Bayes label only where an expert's classification differs (the bounds
of tests/test_torch_int8_serving.py), on at most 2% of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import fusion_math as jfm
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import fusion_math as fm

NUM_CLASSES = 5
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 4, "expert_model": "adapnet",
         "prefixes": {m: m for m in MODALITIES}, "batchsize": 1}
MIN_CHANNELS = 16
SCALE_RTOL = 1e-6
MAX_SHARE = 0.02
PROB_TIE = 2.0 ** -5
DIRICHLET_TIE = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    rng = np.random.RandomState(0)
    return {"rgb": np.round(rng.rand(2, 64, 48, 3) * 255).astype(np.float32),
            "depth": (np.round(rng.rand(2, 64, 48, 1) * 160)
                      / 16).astype(np.float32)}


def _fusion_params():
    rng = np.random.RandomState(2)
    cms = {m: rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
           + np.eye(NUM_CLASSES) * 200 for m in MODALITIES}
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    return cms, params


@pytest.fixture(scope="module")
def small():
    frames = _frames()
    cms, params = _fusion_params()
    jnet = jax_model("average")(data_description=DATA_DESCRIPTION, **SMALL)
    rng = np.random.RandomState(0)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    for k, v in variables.items():
        if k.endswith("moving_mean"):
            variables[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            variables[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith("block_0_1/kernel"):
            variables[k] = np.round(v * 256) / 256
    jnet.variables = {k: jnp.asarray(v) for k, v in variables.items()}
    jscales = jnet.quantize_for_serving(frames, num_batches=2,
                                        min_channels=MIN_CHANNELS)
    jscales_floor0 = jnet.quantize_for_serving(
        frames, num_batches=2, min_channels=MIN_CHANNELS, min_pixels=0)
    jout = []
    for i in range(len(frames["rgb"])):
        ctx = JCtx(jnet.variables, act_scales=jscales,
                   rng=jax.random.PRNGKey(0))
        out = jnet._test_outputs(ctx, jnet._preprocess(
            {k: v[i:i + 1] for k, v in frames.items()}))
        out = {k: np.asarray(v) for k, v in out.items()}
        classes = [out[f"{m}_classification"] for m in MODALITIES]
        out["bayes_mix"] = np.asarray(jnp.argmax(jfm.bayes_fusion(
            classes, [np.asarray(cms[m], np.float32).T for m in MODALITIES],
            "data")[0], 3))
        prior = np.asarray(params["class_counts"], np.float32)
        prior = prior / (1e-20 + prior.sum())
        probs = [out[f"{m}_prob"] / out[f"{m}_prob"].sum(3, keepdims=True)
                 for m in MODALITIES]
        out["dirichlet_mix"] = np.asarray(jnp.argmax(jfm.dirichlet_fusion(
            probs, [np.asarray(params[m], np.float32) for m in MODALITIES],
            prior), 3))
        jout.append(out)
    nets, scales = {}, {}
    for name, extra in (("average", {}),
                        ("bayes_mix", {"confusion_matrices": cms}),
                        ("dirichlet_mix", {"dirichlet_params": params})):
        net = get_model(name)(data_description=DATA_DESCRIPTION,
                              device="cpu", **SMALL, **extra)
        net.variables = from_jax_variables(variables, device="cpu")
        scales[name] = net.quantize_for_serving(frames, num_batches=2,
                                                min_channels=MIN_CHANNELS)
        nets[name] = net
    floor0 = nets["average"].quantize_for_serving(
        frames, num_batches=2, min_channels=MIN_CHANNELS, min_pixels=0)
    port = {}
    for name, net in nets.items():
        net.quantize_for_serving(jscales)
        port[name] = [{k: v.numpy() for k, v in net._forward(
            net._batch_to_device({k: v[i:i + 1] for k, v in frames.items()})
        ).items()} for i in range(len(frames["rgb"]))]
    return {"jax_scales": jscales, "jax_scales_floor0": jscales_floor0,
            "scales": scales, "floor0": floor0, "jax": jout, "port": port,
            "nets": nets,
            "params": params, "prior": prior}


def _assert_scales_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=SCALE_RTOL)


@pytest.mark.parametrize("name", ["average", "bayes_mix", "dirichlet_mix"])
def test_adapnet_int8_scales_match_jax(small, name):
    got = small["scales"][name]
    _assert_scales_equal(got, small["jax_scales"])
    # the floor of 2048 input positions leaves each expert's block_0_2
    assert sorted(got) == [f"{m}/block_0_2/input_amax"
                           for m in ("depth", "rgb")]


def test_adapnet_int8_scales_without_the_floor_match_jax(small):
    got = small["floor0"]
    _assert_scales_equal(got, small["jax_scales_floor0"])
    assert len(got) == 126
    assert "rgb/block_layer_1/stage_1/input_amax" in got


def _assert_near_ties(scores, port_labels, jax_labels, tie):
    assert port_labels.dtype == np.int32
    differ = port_labels != jax_labels
    assert differ.mean() <= MAX_SHARE
    own = np.take_along_axis(scores[differ], port_labels[differ][:, None],
                             1)[:, 0]
    other = np.take_along_axis(scores[differ], jax_labels[differ][:, None],
                               1)[:, 0]
    assert np.all(own - other <= tie * np.abs(own))


@pytest.mark.parametrize("modality", MODALITIES)
def test_adapnet_int8_expert_classifications_match_jax(small, modality):
    for want, got in zip(small["jax"], small["port"]["average"]):
        _assert_near_ties(got[f"{modality}_prob"],
                          got[f"{modality}_classification"],
                          want[f"{modality}_classification"], PROB_TIE)


def test_adapnet_int8_average_labels_match_jax(small):
    for want, got in zip(small["jax"], small["port"]["average"]):
        _assert_near_ties(got["fused_score"], got["prediction"],
                          want["prediction"], PROB_TIE)


def test_adapnet_int8_bayes_labels_match_jax(small):
    for want, got in zip(small["jax"], small["port"]["bayes_mix"]):
        labels = got["prediction"]
        assert labels.dtype == np.int32
        differ = labels != want["bayes_mix"]
        assert differ.mean() <= MAX_SHARE
        expert_differs = np.zeros_like(differ)
        for m in MODALITIES:
            expert_differs |= (got[f"{m}_classification"]
                               != want[f"{m}_classification"])
        assert not (differ & ~expert_differs).any()


def test_adapnet_int8_dirichlet_labels_match_jax(small):
    params = small["params"]
    for want, got in zip(small["jax"], small["port"]["dirichlet_mix"]):
        scores = fm.dirichlet_fusion(
            [torch.from_numpy(got[f"{m}_norm_prob"]) for m in MODALITIES],
            [params[m] for m in MODALITIES], small["prior"]).numpy()
        _assert_near_ties(scores, got["prediction"], want["dirichlet_mix"],
                          DIRICHLET_TIE)


@pytest.mark.parametrize("name", ["average", "bayes_mix", "dirichlet_mix"])
def test_adapnet_int8_runs_the_int8_convs(small, name):
    """The served fusions went through the int8 product, for each
    expert's block_0_2 alone."""
    cached = sorted(small["nets"][name]._kernel_cache.quantized())
    assert cached == [f"{m}/block_0_2/kernel" for m in ("depth", "rgb")]
