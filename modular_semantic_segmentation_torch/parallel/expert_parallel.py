"""Expert parallelism for fusion inference (counterpart of the JAX
package's ``parallel/expert_parallel.py``).

The reference runs its modality experts one after the other inside one
graph. ``dispatch_experts`` runs each expert's forward on its own device
and CUDA stream, in one process, so the experts overlap where the work
allows (on one card as on several); no collectives, and it takes
heterogeneous experts (rgb 3 channels against depth 1).
"""

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops.variables import (
    Ctx, resolve_device)
from modular_semantic_segmentation_torch.parallel.pipeline import (
    default_devices)
from modular_semantic_segmentation_torch.utils.data_io import to_numpy


def dispatch_experts(fusion_model, batch, devices=None):
    """Run each expert's forward pass on its own device and stream.

    Args:
        fusion_model: a fusion model of the port.
        batch: blob dict with batched arrays, one entry per modality.
        devices: ``torch.device``s the experts take in turn (default: a
            card each, ``pipeline.default_devices``).

    Returns {modality: {'prob': np.ndarray, 'classification':
    np.ndarray}}, the experts' outputs in the model's compute dtype.
    """
    from modular_semantic_segmentation_torch.models.fusion_base import \
        test_pipeline
    modalities = fusion_model.modalities
    if devices is None:
        devices = default_devices(len(modalities))
    config = fusion_model.config
    running = {}
    with torch.inference_mode():
        for i, modality in enumerate(modalities):
            device = resolve_device(devices[i % len(devices)])
            prefix = config["prefixes"][modality]
            stream = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
            with torch.cuda.stream(stream):
                variables = {k: v.to(device, non_blocking=True)
                             for k, v in fusion_model.variables.items()
                             if k.startswith(prefix + "/")}
                x = torch.from_numpy(np.ascontiguousarray(batch[modality]))
                x = x.to(device, non_blocking=True)
                ctx = Ctx(variables, compute_dtype=fusion_model.compute_dtype)
                out = test_pipeline(ctx, x, prefix, **config)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
            running[modality] = (out["prob"], out["classification"], ready)
    result = {}
    for modality, (prob, classification, ready) in running.items():
        if ready is not None:
            ready.synchronize()
        result[modality] = {"prob": to_numpy(prob),
                            "classification": to_numpy(classification)}
    return result
