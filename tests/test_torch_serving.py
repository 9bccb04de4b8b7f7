"""The port's InferenceServer against the JAX package's, on the CPU.

Bayes-fused experts at reduced size with the JAX weights carried across;
5 frames at ``unroll=2`` leave a tail group of one frame, which both pad
by repeating it. Served labels must be equal, in order; served
probabilities allclose at atol 1e-5 (float32).
"""

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.serving import \
    InferenceServer as JaxServer
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.serving import (InferenceServer,
                                                         serve_frames)

NUM_CLASSES = 6
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
CONFIG = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
          "prefixes": {"rgb": "rgb", "depth": "depth"}}


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
def models():
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    jnet = jax_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                  confusion_matrices=cms, **CONFIG)
    tnet = get_model("bayes_mix")(data_description=DATA_DESCRIPTION,
                                  confusion_matrices=cms, device="cpu",
                                  **CONFIG)
    tnet.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    return jnet, tnet


def _frames(n=5):
    rng = np.random.RandomState(1)
    return [{"rgb": (rng.rand(32, 48, 3) * 255).astype(np.float32),
             "depth": rng.rand(32, 48, 1).astype(np.float32)}
            for _ in range(n)]


def test_server_matches_jax_with_padded_tail(models):
    jnet, tnet = models
    frames = _frames()
    want = JaxServer(jnet, unroll=2).predict(frames)
    server = InferenceServer(tnet, unroll=2)
    got = list(server.predict_stream(iter(frames)))
    assert len(got) == len(frames)
    np.testing.assert_array_equal(np.stack(got), want)
    # frame by frame: the served label maps are the model's own, in order
    for frame, label in zip(frames, got):
        one = {k: v[None] for k, v in frame.items()}
        np.testing.assert_array_equal(label, tnet.predict(one)[0])


@pytest.mark.parametrize("unroll,max_in_flight", [(1, 1), (3, 2), (8, 3)])
def test_server_output_attr_and_ordering_match_jax(models, unroll,
                                                   max_in_flight):
    jnet, tnet = models
    frames = _frames(4)
    want = JaxServer(jnet, unroll=unroll, max_in_flight=max_in_flight,
                     output_attr="rgb_prob").predict(frames)
    got = serve_frames(tnet, frames, unroll=unroll,
                       max_in_flight=max_in_flight, output_attr="rgb_prob")
    assert got.shape == want.shape == (4, 32, 48, NUM_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_server_rejects_bad_settings(models):
    with pytest.raises(ValueError):
        InferenceServer(models[1], unroll=0)
    with pytest.raises(ValueError):
        InferenceServer(models[1], max_in_flight=0)
