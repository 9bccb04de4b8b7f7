"""The dtypes of the port's label outputs against the JAX package's, on the
CPU: Bayes ``prediction``, Dirichlet ``prediction`` (plain path and the
kernel path, ``use_pallas``), SimpleFCN ``prediction`` and the experts'
``classification``. ``jnp.argmax`` gives int32 (x64 is off), so the port's
labels are int32 too; the label values are held equal as well.

Both packages run the same seeded numpy frames at the reduced size of
tests/test_torch_fusion.py (``num_units=4``, ``channel_factor=0.125``,
6 classes, 32x48), JAX weights carried across.
"""

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables

NUM_CLASSES = 6
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
SMALL = {"num_units": 4, "channel_factor": 0.125, "batchsize": 2}
FUSION = {"expert_model": "fcn", "prefixes": {"rgb": "rgb", "depth": "depth"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_fusion.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    rng = np.random.RandomState(7)
    return {"rgb": (rng.rand(3, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(3, 32, 48, 1).astype(np.float32) * 10,
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (3, 32, 48)).astype(np.int32)}


def _fusion_config(name):
    rng = np.random.RandomState(2)
    if name == "bayes_mix":
        return {"confusion_matrices": {
            m: rng.randint(0, 40, (NUM_CLASSES, NUM_CLASSES))
            + np.eye(NUM_CLASSES) * 200 for m in ("rgb", "depth")}}
    params = {m: rng.rand(NUM_CLASSES, NUM_CLASSES) * 4 + 0.5
              for m in ("rgb", "depth")}
    params["class_counts"] = rng.randint(100, 10000, NUM_CLASSES)
    return {"dirichlet_params": params}


def _pair(name, **config):
    """A JAX model and the port's twin with the same weights. The JAX
    Dirichlet model fuses on its plain path (its Pallas kernel needs a TPU
    outside interpret mode); the port's takes ``use_pallas`` as given."""
    if name == "simple_fcn":
        jconfig = dict(prefix="rgb", modality="rgb", **SMALL)
        description = (DATA_DESCRIPTION[0], DATA_DESCRIPTION[1], NUM_CLASSES)
    else:
        jconfig = dict(**FUSION, **SMALL, **_fusion_config(name))
        description = DATA_DESCRIPTION
    jnet = jax_model(name)(data_description=description, **jconfig)
    tnet = get_model(name)(data_description=description, device="cpu",
                           **jconfig, **config)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    return jnet, tnet


@pytest.mark.parametrize("name,config,attr", [
    ("bayes_mix", {}, "prediction"),
    ("bayes_mix", {}, "rgb_classification"),
    ("bayes_mix", {}, "depth_classification"),
    ("dirichlet_mix", {}, "prediction"),
    ("dirichlet_mix", {"use_pallas": True}, "prediction"),
    ("simple_fcn", {}, "prediction"),
])
def test_label_dtype_matches_jax(name, config, attr):
    jnet, tnet = _pair(name, **config)
    data = _frames()
    want = jnet.predict(data, output_attr=attr)
    got = tnet.predict(data, output_attr=attr)
    assert want.dtype == np.int32
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # and the tensor the model makes, before any readback
    batch = tnet._batch_to_device({k: v[:1] for k, v in data.items()})
    assert tnet._forward(batch)[attr].dtype == torch.int32
