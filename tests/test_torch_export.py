"""The port's deployment artifact (``serving.export_serving`` /
``ExportedServing``) against the JAX package's, on the CPU.

A ``torch.export`` program with the weights as a runtime input, the JAX
package's sidecar npz and manifest keys; it runs without the model
classes (a fresh subprocess checks that no module of ``models/`` gets
loaded) and reaches the kernels through their registered operators. The
SimpleFCN of tests/test_serving.py (32x32, ``num_units`` 4, seed 5),
the JAX weights carried across. Labels exact, probabilities within 1e-5;
an artifact equals in-process ``predict`` bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.datasets import get_dataset
from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.serving import (
    ExportedServing as JaxExportedServing, export_serving as jax_export)
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.serving import (ExportedServing,
                                                         export_serving)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_serving.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(num_test=2):
    return get_dataset("unittest")(height=32, width=32, num_train=4,
                                   num_measure=2, num_test=num_test)


def _port(jnet, name, description, **kwargs):
    net = get_model(name)(data_description=description, device="cpu",
                          **kwargs)
    net.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    return net


@pytest.fixture(scope="module")
def fcn():
    data = _data()
    kwargs = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=1,
                  seed=5)
    jnet = jax_model("simple_fcn")(
        data_description=data.get_data_description(), **kwargs)
    net = _port(jnet, "simple_fcn", data.get_data_description(), **kwargs)
    batch = next(data.get_testset().batches(2))
    return jnet, net, {"rgb": np.asarray(batch["rgb"])}, data


def test_export_serving_roundtrip(fcn, tmp_path):
    """The artifact reproduces ``predict`` without the model class, and
    JAX's artifact of the same weights gives the same labels; re-pointed
    weights change the output."""
    jnet, net, full, _ = fcn
    want = net.predict(full)
    art = export_serving(net, str(tmp_path / "artifact"), full)
    assert sorted(os.listdir(art)) == ["meta.json", "program.pt2",
                                       "weights.npz"]
    served = ExportedServing(art)
    got = served.predict(full)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    jax_art = jax_export(jnet, str(tmp_path / "jax"), full)
    np.testing.assert_array_equal(got, JaxExportedServing(jax_art).predict(
        full))
    # the manifest has the JAX package's keys; the weights its TF names
    with open(os.path.join(jax_art, "meta.json")) as f:
        jax_meta = json.load(f)
    assert set(served.meta) == set(jax_meta)
    assert served.meta["output_attr"] == "prediction"
    assert served.meta["inputs"] == jax_meta["inputs"]
    assert served.meta["platforms"] == ["cpu"]
    with np.load(os.path.join(art, "weights.npz")) as ours, np.load(
            os.path.join(jax_art, "weights.npz")) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
    # re-pointed at same-shape weights: a zeroed score kernel
    served._variables["rgb/score/kernel"] = torch.zeros_like(
        served._variables["rgb/score/kernel"])
    assert not np.array_equal(served.predict(full), want)


def test_export_serving_int8_cross_process(fcn, tmp_path):
    """``quantize_for_serving`` before ``export_serving`` puts the int8
    path in the program (its kernel scales computed there from the weights
    input): the artifact equals in-process int8 ``predict``, differs from
    the float artifact, and a fresh process that loads only the artifact
    (no model module, no JAX) reproduces it."""
    jnet, net, full, data = fcn
    float_prob = net.predict(full, output_attr="prob")
    scales = net.quantize_for_serving(data.get_measureset(), num_batches=1,
                                      min_channels=64, min_pixels=0)
    jax_scales = jnet.quantize_for_serving(data.get_measureset(),
                                           num_batches=1, min_channels=64,
                                           min_pixels=0)
    jnet.dequantize_serving()
    assert scales and set(scales) == set(jax_scales)
    for key, value in jax_scales.items():
        np.testing.assert_allclose(scales[key], value, rtol=1e-5)
    try:
        want = net.predict(full, output_attr="prob")
        int8_art = export_serving(net, str(tmp_path / "int8"), full,
                                  output_attr="prob")
    finally:
        net.dequantize_serving()
    got = ExportedServing(int8_art).predict(full)
    np.testing.assert_array_equal(got, want)
    # not the float program (whose artifact equals float predict, above)
    assert not np.array_equal(float_prob, got)

    inputs_file = str(tmp_path / "inputs.npz")
    out_file = str(tmp_path / "out.npy")
    np.savez(inputs_file, **full)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from modular_semantic_segmentation_torch.serving import "
        "ExportedServing\n"
        f"batch = dict(np.load({inputs_file!r}))\n"
        f"served = ExportedServing({int8_art!r})\n"
        f"np.save({out_file!r}, served.predict(batch))\n"
        "models = [m for m in sys.modules if m.startswith("
        "'modular_semantic_segmentation_torch.models')]\n"
        "print('EXPORT_OK', models, 'jax' in sys.modules)\n")
    result = subprocess.run([sys.executable, "-c", code],
                            capture_output=True, text=True, cwd=REPO,
                            timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "EXPORT_OK [] False" in result.stdout, result.stdout
    np.testing.assert_array_equal(np.load(out_file), want)


def _fusion(name, **kwargs):
    data = _data()
    description = data.get_data_description()
    config = dict(num_units=4, expert_model="fcn", channel_factor=0.25,
                  prefixes={"rgb": "rgb", "depth": "depth"}, batchsize=2,
                  **kwargs)
    jnet = jax_model(name)(data_description=description, **config)
    net = _port(jnet, name, description, **config)
    batch = next(data.get_testset().batches(2))
    return jnet, net, {"rgb": np.asarray(batch["rgb"]),
                       "depth": np.asarray(batch["depth"])}


def test_export_serving_packed_fusion_roundtrip(tmp_path):
    """A Bayes fusion of two experts (its stems through
    ``models/packed_experts.py``) exports like any program; the same
    labels as JAX's artifact."""
    rng = np.random.RandomState(0)
    k = 4
    cms = {m: rng.rand(k, k) + np.eye(k) * 5 for m in ("rgb", "depth")}
    jnet, net, full = _fusion("bayes_mix", confusion_matrices=cms)
    want = net.predict(full)
    got = ExportedServing(export_serving(net, str(tmp_path / "fusion"),
                                         full)).predict(full)
    np.testing.assert_array_equal(got, want)
    jax_art = jax_export(jnet, str(tmp_path / "jax"), full)
    np.testing.assert_array_equal(got, JaxExportedServing(jax_art).predict(
        full))


def test_export_serving_keeps_a_dense_frozen_deconv(tmp_path):
    """A frozen ``upscore`` kernel with an off-diagonal weight is no
    channel-diagonal upsample: the program, whose answers come from the
    weights at export, takes the dense ``conv_transpose2d`` for it, as
    eager ``predict`` does, and gives ``predict``'s rgb probabilities."""
    rng = np.random.RandomState(0)
    k = 4
    cms = {m: rng.rand(k, k) + np.eye(k) * 5 for m in ("rgb", "depth")}
    _, net, full = _fusion("bayes_mix", confusion_matrices=cms)

    def upsamples(directory):
        art = export_serving(net, str(tmp_path / directory), full,
                             output_attr="rgb_prob")
        program = torch.export.load(os.path.join(art, "program.pt2"))
        targets = [str(node.target) for node in program.graph.nodes]
        return art, targets.count("msstorch.diagonal_upsample.default")

    _, diagonal = upsamples("diagonal")
    before = net.predict(full, output_attr="rgb_prob")
    name = "rgb/upscore/kernel"
    kernel = net.variables[name].clone()
    kernel[3, 5, 0, 1] = 0.5
    net.variables[name] = kernel
    want = net.predict(full, output_attr="rgb_prob")
    assert not np.array_equal(want, before)
    art, dense = upsamples("dense")
    assert dense == diagonal - 1
    np.testing.assert_array_equal(ExportedServing(art).predict(full), want)


def test_export_serving_dirichlet_kernel_operator(tmp_path):
    """``DirichletFusion(use_pallas=True)``: kernel B is in the program as
    the registered operator ``msstorch::dirichlet_label`` (its plain
    version on the CPU), and the artifact gives ``predict``'s labels.
    Exported before the model has served, the program builds the
    kernel's tables itself and leaves the model's to its first
    ``predict``."""
    rng = np.random.RandomState(1)
    params = {m: rng.rand(4, 4) * 3 + 1 for m in ("rgb", "depth")}
    params["class_counts"] = rng.rand(4) + 1
    _, net, full = _fusion("dirichlet_fusion", use_pallas=True,
                           dirichlet_params=params)
    art = export_serving(net, str(tmp_path / "dirichlet"), full)
    want = net.predict(full)
    program = torch.export.load(os.path.join(art, "program.pt2"))
    targets = {str(node.target) for node in program.graph.nodes}
    assert "msstorch.dirichlet_label.default" in targets
    np.testing.assert_array_equal(ExportedServing(art).predict(full), want)


def test_export_serving_mc_dropout_seeds(tmp_path):
    """An MC-dropout program (BayesianFCN) samples from the seed each call
    gets: one ``seed`` gives one stream, successive calls differ, and at
    dropout 0 the artifact equals ``predict``."""
    data = _data()
    description = data.get_data_description()
    batch = {"rgb": np.asarray(next(data.get_testset().batches(2))["rgb"])}
    kwargs = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=2,
                  seed=5, num_samples=2, channel_factor=0.25)
    for rate in (0.5, 0.0):
        jnet = jax_model("bayesian_fcn")(data_description=description,
                                         dropout_rate=rate, **kwargs)
        net = _port(jnet, "bayesian_fcn", description, dropout_rate=rate,
                    **kwargs)
        art = export_serving(net, str(tmp_path / f"mc{rate}"), batch,
                             output_attr="prob")
        first, second = ExportedServing(art, seed=3), ExportedServing(
            art, seed=3)
        a, b = first.predict(batch), first.predict(batch)
        np.testing.assert_array_equal(a, second.predict(batch))
        if rate:
            assert not np.array_equal(a, b)
        else:
            want = net.predict(batch, output_attr="prob")
            np.testing.assert_array_equal(a, want)
            np.testing.assert_array_equal(b, want)
            np.testing.assert_allclose(
                a, jnet.predict(batch, output_attr="prob"), rtol=0,
                atol=1e-5)
