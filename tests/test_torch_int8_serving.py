"""The port's int8 post-training-quantized serving against the JAX
package's, on the CPU, in float32: calibration and scale selection on the
same measure frames, then the int8 labels of SimpleFCN, Average, Bayes,
Dirichlet (plain and kernel paths) and Variance; the packed stem against
a block-diagonal int8 conv; dequantization, reuse of a scales dict, and
the serving mode an InferenceServer fixes.

SMALL size, as tests/test_torch_bf16_fusion.py: 2 frames of 64x96,
``num_units=8``, ``channel_factor=0.25``, 14 classes, JAX weights carried
across. ``min_channels=16`` sends every conv from conv1_2 on to int8
(the packed stems judged 32 wide), except the class score conv (8 in).

The int8 convs of the two packages agree bit for bit on the same inputs
and scales (tests/test_torch_quantize.py). Upstream of them the two
differ in the last bits: conv1_1 runs in float32 and sums in another
order, the calibrated scales are maxima of float32 activations, and the
JAX package's compiled program multiplies by the reciprocal of a constant
scale where its source divides by it (XLA's rewrite). An input that lands
on a rounding midpoint of ``x / ascale`` then quantizes to the other
side, and each later int8 layer spreads such flips. So labels may differ:
at most 2% per model, every difference a near tie of the port's own
scores, with the bounds of tests/test_torch_bf16_fusion.py: probabilities
and Average scores within 2**-5 relative (well inside how far the int8
path itself moves the probabilities from float), Dirichlet log scores
within 2**-7 relative, and a Bayes label only where an expert's
classification differs.

JAX's VarianceFusion builds its experts at full width whatever
``channel_factor`` says, so Variance is compared at full width. Through
13 int8 layers of 64..512 channels the flips above spread past the 2%
bound, so that test removes their sources: integer
pixel values and conv1_1 kernels rounded to multiples of 2**-8 make
conv1_1's sums exact in float32 in any order, and both packages serve
with JAX's scales (the port takes them as ``data``). The labels then
equal those of JAX's model run op by op (no XLA rewrite), and differ from
its compiled eval step's as above.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import fusion_math as jfm
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.packed_experts import \
    packed_fcn_stems
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.ops import int8_conv
from modular_semantic_segmentation_torch.ops.layers import _same_pads
from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.serving import InferenceServer

NUM_CLASSES = 14
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 8, "channel_factor": 0.25, "expert_model": "fcn",
         "batchsize": 1, "prefixes": {m: m for m in MODALITIES}}
MIN_CHANNELS = 16
MAX_SHARE = 0.02
PROB_TIE = 2.0 ** -5
DIRICHLET_TIE = 2.0 ** -7
STEM_CONVS = ("conv1_1", "conv1_2", "conv2_1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(integer=False):
    rng = np.random.RandomState(0)
    rgb = rng.rand(2, 64, 96, 3) * 255
    depth = rng.rand(2, 64, 96, 1) * 10
    if integer:
        rgb, depth = np.round(rgb), np.round(depth * 16) / 16
    return {"rgb": rgb.astype(np.float32), "depth": depth.astype(np.float32)}


def _fusion_config():
    rng = np.random.RandomState(2)
    cms = {m: rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
           + np.eye(NUM_CLASSES) * 200 for m in MODALITIES}
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in MODALITIES}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    return cms, params


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_outputs(jnet, frames):
    return [_numpy(jnet._jit_eval_step(
        jnet.variables, {k: v[i:i + 1] for k, v in frames.items()},
        jnet._next_rng())) for i in range(len(frames["rgb"]))]


def _port_outputs(net, frames):
    outs = []
    for i in range(len(frames["rgb"])):
        out = net._forward(net._batch_to_device(
            {k: v[i:i + 1] for k, v in frames.items()}))
        outs.append({k: v.numpy() for k, v in out.items()})
    return outs


def _port(name, variables, frames, **config):
    net = get_model(name)(data_description=DATA_DESCRIPTION, device="cpu",
                          **config)
    net.variables = from_jax_variables(variables, device="cpu")
    scales = net.quantize_for_serving(frames, num_batches=2,
                                      min_channels=MIN_CHANNELS)
    return net, scales


@pytest.fixture(scope="module")
def small():
    """JAX's int8 scales and outputs, and the port's, per model."""
    frames = _frames()
    cms, params = _fusion_config()
    jnet = jax_model("average")(data_description=DATA_DESCRIPTION, **SMALL)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    jscales = jnet.quantize_for_serving(frames, num_batches=2,
                                        min_channels=MIN_CHANNELS)
    jout = _jax_outputs(jnet, frames)
    prior = np.asarray(params["class_counts"], np.float32)
    prior = prior / (1e-20 + prior.sum())
    for out in jout:
        classes = [out[f"{m}_classification"] for m in MODALITIES]
        out["bayes_mix"] = np.asarray(jnp.argmax(jfm.bayes_fusion(
            classes, [np.asarray(cms[m], np.float32).T for m in MODALITIES],
            "data")[0], 3))
        probs = [out[f"{m}_prob"] / out[f"{m}_prob"].sum(3, keepdims=True)
                 for m in MODALITIES]
        out["dirichlet_mix"] = np.asarray(jnp.argmax(jfm.dirichlet_fusion(
            probs, [np.asarray(params[m], np.float32) for m in MODALITIES],
            prior), 3))
    expert = {"prefix": "rgb", "modality": "rgb", "num_units": 8,
              "channel_factor": 0.25, "batch_normalization": False}
    jexpert = jax_model("simple_fcn")(data_description=DATA_DESCRIPTION,
                                      **expert)
    jexpert.variables = {k: v for k, v in jnet.variables.items()
                         if k.startswith("rgb/")}
    jexpert_scales = jexpert.quantize_for_serving(
        frames, num_batches=2, min_channels=MIN_CHANNELS)
    nets, scales = {}, {}
    nets["simple_fcn"], scales["simple_fcn"] = _port(
        "simple_fcn", jexpert.variables, frames, **expert)
    for key, name, extra in (
            ("average", "average", {}),
            ("bayes_mix", "bayes_mix", {"confusion_matrices": cms}),
            ("dirichlet_mix", "dirichlet_mix", {"dirichlet_params": params}),
            ("dirichlet_kernel", "dirichlet_mix",
             {"dirichlet_params": params, "use_pallas": True})):
        nets[key], scales[key] = _port(name, variables, frames, **SMALL,
                                       **extra)
    return {"frames": frames, "variables": variables, "jax_scales": jscales,
            "jax_expert_scales": jexpert_scales, "jax": jout,
            "jax_expert": _jax_outputs(jexpert, frames), "nets": nets,
            "scales": scales,
            "port": {name: _port_outputs(net, frames)
                     for name, net in nets.items()},
            "prior": prior, "params": params}


def _gaps(scores, port_labels, jax_labels):
    """Where the labels differ: the port's score of its own label minus
    that of JAX's label, and the former."""
    differ = port_labels != jax_labels
    own = np.take_along_axis(scores[differ], port_labels[differ][:, None],
                             1)[:, 0]
    other = np.take_along_axis(scores[differ], jax_labels[differ][:, None],
                               1)[:, 0]
    return differ, own - other, np.abs(own)


def _assert_near_ties(scores, port_labels, jax_labels, tie):
    assert port_labels.dtype == np.int32
    differ, gap, own = _gaps(scores, port_labels, jax_labels)
    assert differ.mean() <= MAX_SHARE
    assert np.all(gap <= tie * own)


def _assert_scales_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert isinstance(got[key], float)
        np.testing.assert_allclose(got[key], value, rtol=1e-5)


@pytest.mark.parametrize("name", ["simple_fcn", "average", "bayes_mix",
                                  "dirichlet_mix", "dirichlet_kernel"])
def test_int8_scales_match_jax(small, name):
    want = (small["jax_expert_scales"] if name == "simple_fcn"
            else small["jax_scales"])
    got = small["scales"][name]
    _assert_scales_equal(got, want)
    assert small["nets"][name].act_scales == got
    if name == "simple_fcn":
        assert not any(k.startswith("packed:") for k in got)
        return
    # the packed stem convs, each expert with its own key; no stem conv
    # has an unpacked key
    for m in MODALITIES:
        for conv in ("conv1_2", "conv2_1"):
            assert f"packed:{m}/{conv}/input_amax" in got
        for conv in STEM_CONVS:
            assert f"{m}/{conv}/input_amax" not in got
    assert "rgb/conv2_2/input_amax" in got


def test_int8_expert_labels_match_jax(small):
    for want, got in zip(small["jax_expert"], small["port"]["simple_fcn"]):
        _assert_near_ties(got["prob"], got["prediction"], want["prediction"],
                          PROB_TIE)


@pytest.mark.parametrize("modality", MODALITIES)
def test_int8_fusion_expert_classifications_match_jax(small, modality):
    for want, got in zip(small["jax"], small["port"]["average"]):
        _assert_near_ties(got[f"{modality}_prob"],
                          got[f"{modality}_classification"],
                          want[f"{modality}_classification"], PROB_TIE)


def test_int8_average_labels_match_jax(small):
    for want, got in zip(small["jax"], small["port"]["average"]):
        _assert_near_ties(got["fused_score"], got["prediction"],
                          want["prediction"], PROB_TIE)


def test_int8_bayes_labels_match_jax(small):
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


@pytest.mark.parametrize("name", ["dirichlet_mix", "dirichlet_kernel"])
def test_int8_dirichlet_labels_match_jax(small, name):
    params = small["params"]
    for want, got in zip(small["jax"], small["port"][name]):
        scores = fm.dirichlet_fusion(
            [torch.from_numpy(got[f"{m}_norm_prob"]) for m in MODALITIES],
            [params[m] for m in MODALITIES], small["prior"]).numpy()
        _assert_near_ties(scores, got["prediction"], want["dirichlet_mix"],
                          DIRICHLET_TIE)


def test_int8_variance_labels_match_jax():
    """Full width (JAX's VarianceFusion ignores ``channel_factor``), at
    dropout 0, conv1_1 exact in both packages, both serving with JAX's
    scales (module docstring): the labels equal those of JAX's model run
    op by op, and differ from its compiled eval step's on at most 2%, each
    a near tie."""
    frames = _frames(integer=True)
    config = {"num_units": 8, "expert_model": "fcn", "batchsize": 1,
              "prefixes": {m: m for m in MODALITIES}, "num_samples": 2,
              "dropout_rate": 0.0}
    jnet = jax_model("variance")(data_description=DATA_DESCRIPTION,
                                 **config)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    for m in MODALITIES:
        key = f"{m}/conv1_1/kernel"
        variables[key] = np.round(variables[key] * 256) / 256
    jnet.variables = {k: jnp.asarray(v) for k, v in variables.items()}
    jscales = jnet.quantize_for_serving(frames, num_batches=2,
                                        min_channels=MIN_CHANNELS)
    net, scales = _port("variance", variables, frames, **config)
    _assert_scales_equal(scales, jscales)
    assert "packed:depth/conv2_1/input_amax" in scales
    net.quantize_for_serving(jscales)
    compiled = _jax_outputs(jnet, frames)
    for i, got in enumerate(_port_outputs(net, frames)):
        frame = {k: v[i:i + 1] for k, v in frames.items()}
        ctx = JCtx(jnet.variables, act_scales=jscales,
                   rng=jax.random.PRNGKey(0))
        op_by_op = jnet._test_outputs(ctx, jnet._preprocess(frame))
        np.testing.assert_array_equal(got["prediction"],
                                      np.asarray(op_by_op["prediction"]))
        _assert_near_ties(got["fused_score"], got["prediction"],
                          compiled[i]["prediction"], PROB_TIE)


def _block_diagonal(kernels):
    kh, kw = kernels[0].shape[:2]
    out = torch.zeros((kh, kw, sum(k.shape[2] for k in kernels),
                       sum(k.shape[3] for k in kernels)))
    i = o = 0
    for k in kernels:
        out[:, :, i:i + k.shape[2], o:o + k.shape[3]] = k
        i += k.shape[2]
        o += k.shape[3]
    return out


def _block_diagonal_int8_conv(x, kernels, biases, scales):
    """The JAX package's packed int8 stem conv, built here: one
    block-diagonal kernel, each expert's input channels quantized with its
    own scale, each output channel dequantized with its expert's scale x
    the per-channel kernel scale; + bias, ReLU (float32)."""
    kernel = _block_diagonal(kernels)
    ascale_in = torch.cat([torch.full((k.shape[2],), s) for k, s in
                           zip(kernels, scales)])
    ascale_out = torch.cat([torch.full((k.shape[3],), s) for k, s in
                            zip(kernels, scales)])
    kq, kscale = int8_conv.quantize_kernel(kernel)
    xq = int8_conv.quantize(x, ascale_in)
    n, h, w, _ = x.shape
    pads = (_same_pads(h, 3, 1, 1), _same_pads(w, 3, 1, 1))
    acc = int8_conv.int8_conv2d(
        xq, kq.reshape(-1, kq.shape[-1]).t().contiguous(), (3, 3), (1, 1),
        (1, 1), pads)
    return torch.relu(acc.float() * (ascale_out * kscale)
                      + torch.cat(biases))


def test_packed_stem_equals_block_diagonal_int8_conv(small):
    net = small["nets"]["average"]
    frames = small["frames"]
    batch = net._preprocess(net._batch_to_device(
        {k: v[:1] for k, v in frames.items()}))
    with torch.inference_mode():
        ctx = Ctx(net.variables, act_scales=net.act_scales)
        stems = packed_fcn_stems(ctx, batch, list(MODALITIES),
                                 SMALL["prefixes"], channel_factor=0.25)
    for conv, source in (("conv1_2", "conv1_1"), ("conv2_1", "pool1")):
        x = torch.cat([stems[m][source] for m in MODALITIES], dim=-1)
        want = _block_diagonal_int8_conv(
            x, [net.variables[f"{m}/{conv}/kernel"] for m in MODALITIES],
            [net.variables[f"{m}/{conv}/bias"] for m in MODALITIES],
            [torch.tensor(net.act_scales[f"packed:{m}/{conv}/input_amax"],
                          dtype=torch.float32) for m in MODALITIES])
        got = torch.cat([stems[m][conv] for m in MODALITIES], dim=-1)
        assert torch.equal(got, want), conv


def test_unpacked_stem_keys_are_never_read_by_the_packed_stem(small):
    """A scales dict that holds only unpacked stem keys leaves the packed
    stem on the float path; with packing off, the same keys make conv1_2
    and conv2_1 int8."""
    frames = small["frames"]
    net = small["nets"]["average"]
    unpacked = {f"{m}/{conv}/input_amax": 0.05 for m in MODALITIES
                for conv in STEM_CONVS}
    batch = net._batch_to_device({k: v[:1] for k, v in frames.items()})
    floated = net._forward_with_scales(batch, None)
    through_packed = net._forward_with_scales(batch, unpacked)
    assert torch.equal(through_packed["rgb_prob"], floated["rgb_prob"])
    net.config["pack_experts"] = False
    try:
        unpacked_path = net._forward_with_scales(batch, unpacked)
    finally:
        del net.config["pack_experts"]
    assert not torch.equal(unpacked_path["rgb_prob"], floated["rgb_prob"])


def test_dequantize_restores_float_bit_for_bit(small):
    net = get_model("average")(data_description=DATA_DESCRIPTION,
                               device="cpu", **SMALL)
    net.variables = from_jax_variables(small["variables"], device="cpu")
    frames = small["frames"]
    floated = _port_outputs(net, frames)
    net.quantize_for_serving(small["scales"]["average"])
    quantized = _port_outputs(net, frames)
    assert not np.array_equal(quantized[0]["fused_score"],
                              floated[0]["fused_score"])
    net.dequantize_serving()
    assert net.act_scales is None
    for want, got in zip(floated, _port_outputs(net, frames)):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_scales_dict_as_data_reproduces_outputs(small):
    scales = small["scales"]["bayes_mix"]
    cms, _ = _fusion_config()
    net = get_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                 device="cpu", confusion_matrices=cms,
                                 **SMALL)
    net.variables = from_jax_variables(small["variables"], device="cpu")
    assert net.quantize_for_serving(scales) is scales
    for want, got in zip(small["port"]["bayes_mix"],
                         _port_outputs(net, small["frames"])):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_server_fixes_its_mode_at_its_first_group(small):
    """A server that has served before quantize_for_serving keeps serving
    float; one that had not served yet serves int8; and the other way
    round after dequantize_serving."""
    net = get_model("average")(data_description=DATA_DESCRIPTION,
                               device="cpu", **SMALL)
    net.variables = from_jax_variables(small["variables"], device="cpu")
    frames = [{k: v[i] for k, v in small["frames"].items()}
              for i in range(2)]
    floated = np.stack([o["prediction"][0]
                        for o in _port_outputs(net, small["frames"])])
    warmed = InferenceServer(net, unroll=1)
    cold = InferenceServer(net, unroll=1)
    np.testing.assert_array_equal(warmed.predict(frames), floated)
    net.quantize_for_serving(small["scales"]["average"])
    quantized = np.stack([o["prediction"][0]
                          for o in _port_outputs(net, small["frames"])])
    assert not np.array_equal(quantized, floated)
    np.testing.assert_array_equal(warmed.predict(frames), floated)
    np.testing.assert_array_equal(cold.predict(frames), quantized)
    net.dequantize_serving()
    np.testing.assert_array_equal(cold.predict(frames), quantized)
    np.testing.assert_array_equal(
        InferenceServer(net, unroll=1).predict(frames), floated)


def test_int8_score_counts_its_own_predictions(small):
    net = small["nets"]["bayes_mix"]
    frames = dict(small["frames"])
    rng = np.random.RandomState(5)
    frames["labels"] = rng.randint(-1, NUM_CLASSES,
                                   (2, 64, 96)).astype(np.int32)
    _, confusion = net.score(frames)
    predictions = np.stack([o["prediction"][0]
                            for o in small["port"]["bayes_mix"]])
    valid = frames["labels"] >= 0
    want = np.zeros((NUM_CLASSES, NUM_CLASSES), np.float32)
    np.add.at(want, (frames["labels"][valid], predictions[valid]), 1)
    np.testing.assert_array_equal(confusion, want)
