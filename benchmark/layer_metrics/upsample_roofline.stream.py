"""The frozen bilinear upsampling's share (%) of its roofline, at every
shape the configuration's experts call it with.

The benchmark calls the program's public ``ops.fast_upsample
.diagonal_upsample`` itself, in the served dtype, on a seeded input and
the bilinear kernel, each call timed with CUDA events after an L2 flush.
A call's least time is the larger of its FLOPs (2 k^2 per input pixel and
channel) over the bf16 peak and its bytes (the input, the kernel's
diagonal and the output, each once) over the HBM bandwidth. The metric is
the sum of the least times over the sum of the measured ones. It reads
the same work whatever implements the function.
"""

import torch

from benchmark.harness.timing import cold_ms
from benchmark.reference.layers import bilinear_kernel


def read(obs):
    calls = obs.family.upsample_calls(obs.config)
    if not calls or obs.peaks is None or obs.run.device.type != "cuda":
        return None
    from modular_semantic_segmentation_torch.ops.fast_upsample import \
        diagonal_upsample
    dtype = getattr(torch, obs.config["serve"]["dtype"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=obs.run.device)
    gen.manual_seed(obs.run.seeds["extra"])
    least = measured = 0.0
    for h, w, c, k, s in calls:
        x = torch.rand((1, h, w, c), generator=gen, device=obs.run.device,
                       ).to(dtype)
        idx = torch.arange(c)
        diag = torch.from_numpy(bilinear_kernel(k, c))[:, :, idx, idx].to(
            obs.run.device, dtype)
        flops = 2 * k * k * c * h * w
        nbytes = itemsize * (h * w * c + k * k * c + h * s * w * s * c)
        least += max(flops / obs.peaks["bf16_flops"],
                     nbytes / obs.peaks["hbm_bytes_per_s"])
        measured += 1e-3 * cold_ms(lambda: diagonal_upsample(x, diag, s))
    return 100.0 * least / measured
