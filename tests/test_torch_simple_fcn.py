"""The port's SimpleFCN expert, its Estimator runtime and npz weight IO
against the JAX package, on the CPU.

Small experts (``channel_factor=0.125``, ``num_units=4``, 32x48 inputs)
with the JAX model's weights carried across by ``from_jax_variables``.
Tolerances: ``prob`` allclose at atol 1e-5 (float32, sums in another
order); ``prediction``, confusion matrices and measures exact.
"""

import os

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models import params
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables

NUM_CLASSES = 5
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)
CONFIG = {"num_units": 4, "channel_factor": 0.125, "batchsize": 2}
DEMO_WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "notebooks",
                            "demo_storage", "experiments", "1",
                            "SimpleFCN_weights_30.npz")


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


@pytest.fixture(scope="module")
def experts():
    """A JAX SimpleFCN with random BN statistics, and the port's twin."""
    jnet = jax_model("simple_fcn")(prefix="rgb", modality="rgb",
                                   data_description=DATA_DESCRIPTION,
                                   **CONFIG)
    rng = np.random.RandomState(0)
    variables = {k: np.asarray(v) for k, v in jnet.variables.items()}
    for k, v in variables.items():
        if k.endswith(("moving_mean", "beta")):
            variables[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith(("moving_variance", "gamma")):
            variables[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
    jnet.variables = variables
    tnet = get_model("simple_fcn")(prefix="rgb", modality="rgb",
                                   data_description=DATA_DESCRIPTION,
                                   device="cpu", **CONFIG)
    assert sorted(tnet.variables) == sorted(variables)
    for k, v in tnet.variables.items():
        assert tuple(v.shape) == variables[k].shape, k
    tnet.variables = from_jax_variables(variables, device="cpu")
    return jnet, tnet


def _data(seed=0, n=3, height=32, width=48):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, height, width, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, height, width)).astype(np.int32)}


def test_simple_fcn_prob_and_prediction_match_jax(experts):
    jnet, tnet = experts
    data = _data()
    np.testing.assert_allclose(tnet.predict(data, output_attr="prob"),
                               jnet.predict(data, output_attr="prob"),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tnet.predict(data), jnet.predict(data))


def test_score_matches_jax(experts):
    """3 frames at batch size 2: the partial batch is padded with label
    -1, which the confusion matrix ignores."""
    jnet, tnet = experts
    data = _data(seed=1)
    jmeasures, jcm = jnet.score(data)
    tmeasures, tcm = tnet.score(data)
    np.testing.assert_array_equal(tcm, jcm)
    assert tcm.sum() == (data["labels"] >= 0).sum()
    assert sorted(tmeasures) == sorted(jmeasures)
    for key in jmeasures:
        np.testing.assert_array_equal(tmeasures[key], jmeasures[key])


def test_preprocess_scaling_and_uint8_match_jax(experts):
    """``input_scaling`` and the promotion of integer frames."""
    jnet, tnet = experts
    data = _data(seed=2, n=2)
    frames = {"rgb": data["rgb"].astype(np.uint8)}
    np.testing.assert_allclose(tnet.predict(frames, output_attr="prob"),
                               jnet.predict(frames, output_attr="prob"),
                               atol=1e-5, rtol=0)
    for net in experts:
        net.config["input_scaling"] = {"rgb": (1 / 255.0, -0.5)}
    # the JAX step reads the config while tracing: trace it anew
    jnet._rejit_eval_step()
    try:
        np.testing.assert_allclose(
            tnet.predict(frames, output_attr="prob"),
            jnet.predict(frames, output_attr="prob"), atol=1e-5, rtol=0)
    finally:
        for net in experts:
            net.config.pop("input_scaling")
        jnet._rejit_eval_step()


def test_jax_exported_weights_import_with_translate_prefix(experts,
                                                           tmp_path):
    """An npz that the JAX Estimator exports loads into a port model under
    another prefix (translate_prefix) and gives the same outputs."""
    jnet, _ = experts
    path = jnet.export_weights(str(tmp_path))
    other = get_model("simple_fcn")(prefix="cam", modality="rgb",
                                    data_description=DATA_DESCRIPTION,
                                    device="cpu", seed=7, **CONFIG)
    report = other.import_weights(path, translate_prefix="cam",
                                  warnings=False)
    assert report == {"missing": [], "mismatched": []}
    data = _data(seed=3, n=2)
    np.testing.assert_allclose(other.predict(data, output_attr="prob"),
                               jnet.predict(data, output_attr="prob"),
                               atol=1e-5, rtol=0)


def test_port_exported_weights_round_trip(experts, tmp_path):
    """The port's export is the same npz contract: names, layouts and
    global_step, readable by the JAX package's importer."""
    jnet, tnet = experts
    path = tnet.export_weights(str(tmp_path))
    with np.load(path) as archive:
        assert int(archive["global_step"]) == 0
        for k, v in tnet.variables.items():
            np.testing.assert_array_equal(archive[k], v.numpy())
    from modular_semantic_segmentation_tpu.models.params import \
        import_weights as jax_import
    imported, report = jax_import(jnet.variables, path, warnings=False)
    assert report == {"missing": [], "mismatched": []}
    for k, v in imported.items():
        np.testing.assert_array_equal(v, tnet.variables[k].numpy())


def test_import_reports_missing_and_mismatched(tmp_path):
    net = get_model("simple_fcn")(prefix="rgb", modality="rgb",
                                  data_description=DATA_DESCRIPTION,
                                  device="cpu", **CONFIG)
    store = {k: v.numpy() for k, v in net.variables.items()}
    store.pop("rgb/score/bias")
    store["rgb/conv1_1/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    path = params.export_weights(store, str(tmp_path), "partial")
    before = net.variables["rgb/conv1_1/kernel"].clone()
    report = net.import_weights(path, warnings=False)
    assert report == {"missing": ["rgb/score/bias"],
                      "mismatched": ["rgb/conv1_1/kernel"]}
    assert torch.equal(net.variables["rgb/conv1_1/kernel"], before)


def test_repo_demo_weights_load():
    """The repository's own demo expert (full-width VGG16 with BN,
    num_units=4, 4 classes) loads completely and runs."""
    description = ({"rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)}, 4)
    net = get_model("fcn")(prefix="rgb", modality="rgb",
                           data_description=description, num_units=4,
                           device="cpu")
    report = net.import_weights(DEMO_WEIGHTS, warnings=False)
    assert report == {"missing": [], "mismatched": []}
    frame = {"rgb": np.random.RandomState(0).rand(1, 32, 32, 3).astype(
        np.float32) * 255}
    prob = net.predict(frame, output_attr="prob")
    assert prob.shape == (1, 32, 32, 4) and np.isfinite(prob).all()
    np.testing.assert_allclose(prob.sum(-1), 1.0, atol=1e-5)
