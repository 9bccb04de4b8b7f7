"""Pipeline parallelism for serving: network stages on their own devices
(counterpart of the JAX package's ``parallel/pipeline.py``).

One process, as in the JAX package. The network is split into stages;
each stage's variables live on its device, and each stage runs on a CUDA
stream of its own, so stage ``i`` of microbatch ``m`` may overlap stage
``i+1`` of microbatch ``m-1`` (GPipe's inference schedule; inference has
no backward, so no bubbles), on one card as on several. A stage waits for
its input through an event of the previous stage's stream.
"""

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops.variables import resolve_device
from modular_semantic_segmentation_torch.utils.data_io import to_numpy


def _tree_map(fn, value):
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_map(fn, v) for v in value)
    return fn(value)


def default_devices(count):
    """One card per stage where there are enough, else the cards in
    turn."""
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(count)]


def _to_stage(value, device, stream):
    """``value`` (host array or tensor) on ``device``, usable on
    ``stream``."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    if value.device != device:
        if device.type == "cuda" and value.device.type == "cpu":
            value = value.pin_memory()
        return value.to(device, non_blocking=True)
    if stream is not None:
        # made on another stream: keep its memory until this one is done
        value.record_stream(stream)
    return value


class Pipeline:
    """Multi-stage pipelined executor.

    Args:
        stages: list of ``(fn, variables)`` where ``fn(variables, x) -> y``
            is a stage function; stage 0 receives the microbatch, each
            later stage the previous stage's output.
        devices: one ``torch.device`` per stage (default: a card each,
            :func:`default_devices`).
    """

    def __init__(self, stages, devices=None):
        if devices is None:
            devices = default_devices(len(stages))
        if len(devices) != len(stages):
            raise ValueError(
                f"{len(stages)} stages need {len(stages)} devices, "
                f"got {len(devices)}")
        self._stages = []
        for (fn, variables), device in zip(stages, devices):
            device = resolve_device(device)
            placed = {key: value.to(device)
                      for key, value in variables.items()}
            stream = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
            self._stages.append((fn, placed, device, stream))

    def dispatch(self, microbatches):
        """Stream microbatches through all stages; returns per-microbatch
        outputs, queued on the last stage's stream."""
        outputs = []
        with torch.inference_mode():
            for microbatch in microbatches:
                value, ready = microbatch, None
                for fn, variables, device, stream in self._stages:
                    if stream is None:
                        value = _tree_map(
                            lambda v: _to_stage(v, device, None), value)
                        value = fn(variables, value)
                        continue
                    with torch.cuda.stream(stream):
                        if ready is not None:
                            stream.wait_event(ready)
                        value = _tree_map(
                            lambda v: _to_stage(v, device, stream), value)
                        value = fn(variables, value)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                outputs.append((value, ready))
        return outputs

    def __call__(self, microbatches):
        """Pipelined run; waits and returns the outputs stacked along the
        batch as numpy."""
        outputs = []
        for value, ready in self.dispatch(microbatches):
            if ready is not None:
                ready.synchronize()
            outputs.append(to_numpy(value))
        return np.concatenate(outputs, axis=0)


def fcn_inference_pipeline(estimator, devices=None):
    """Split a SimpleFCN estimator into an (encoder | decoder) two-stage
    inference pipeline (stage boundary at the 'fused' skip feature).

    Returns a :class:`Pipeline` whose microbatch outputs are the argmax
    predictions, those of ``estimator.predict``.
    """
    from modular_semantic_segmentation_torch.models.simple_fcn import (
        decoder, encoder)
    from modular_semantic_segmentation_torch.ops import layers as ll
    from modular_semantic_segmentation_torch.ops.variables import Ctx

    config = estimator.config
    prefix, modality = estimator.prefix, estimator.modality
    decoder_scopes = (f"{prefix}/upscore/", f"{prefix}/score/")
    encoder_vars, decoder_vars = {}, {}
    for name, value in estimator.variables.items():
        target = (decoder_vars if name.startswith(decoder_scopes)
                  else encoder_vars)
        target[name] = value
    # one cache serves both stages: their scope names differ
    cache = ll.KernelCache()

    def context(variables):
        return Ctx(variables, compute_dtype=estimator.compute_dtype,
                   kernel_cache=cache, act_scales=estimator.act_scales)

    def encoder_stage(variables, batch):
        inputs = estimator._preprocess(batch)[modality]
        return encoder(context(variables), inputs, prefix,
                       config["num_units"],
                       batchnorm=config["batch_normalization"],
                       channel_factor=config.get("channel_factor", 1.0)
                       )["fused"]

    def decoder_stage(variables, features):
        score = decoder(context(variables), features, prefix,
                        config["num_units"], config["num_classes"],
                        batchnorm=config["batch_normalization"])["score"]
        return ll.softmax(score).argmax(-1).to(torch.int32)

    return Pipeline([(encoder_stage, encoder_vars),
                     (decoder_stage, decoder_vars)], devices=devices)
