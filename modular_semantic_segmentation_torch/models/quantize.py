"""Post-training int8 quantization for serving (counterpart of the JAX
package's ``models/quantize.py``).

The recipe is the JAX package's:
  * symmetric per-tensor activation scales, calibrated as the largest
    |input| of each conv (or a percentile of it) over a few measure-set
    batches;
  * symmetric per-output-channel kernel scales, computed from the stored
    float32 kernels (``ops/layers.conv2d``), so the npz weight contract is
    untouched;
  * only convs with at least ``min_channels`` input channels and at least
    ``min_pixels`` input positions are quantized; everything else (bias,
    BN, activations, fusion math) stays float.

The thresholds are the JAX package's defaults, chosen there from TPU
measurements; what int8 is worth on the H100 is measured by
``chip_smoke.py`` (PERF.md).

Usage:
    net.quantize_for_serving(measure_set)   # calibrate + enable
    net.score(test_set)                     # runs the int8 convs
"""

import math

import torch

from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.utils.data_io import iterate_batches

#: the stem convs that run through the ``packed:`` scales of the expert
#: stems (``models/packed_experts.py``); conv1_1 stays float there
PACKED_STEM_CONVS = ("conv1_2", "conv2_1")


def calibrate_amax(net, data, num_batches=8, percentile=100.0):
    """Run ``num_batches`` batches of ``data`` through the test network,
    recording each conv input's absolute max (or the given percentile of
    |input| per batch; across batches the estimate is the running max).

    Trailing batches are padded with zero frames, as in the JAX package,
    and the zeros enter a percentile below 100 as they do there. Stochastic
    layers draw from a generator seeded 0 for every batch, so calibration
    leaves the model's own random stream where it was.

    Returns a dict full-scope-name -> float (e.g.
    ``'rgb/conv4_1/input_amax' -> 5.31``, ``'rgb/conv4_1/input_pixels' ->
    4608.0``).
    """
    running = {}
    for i, (batch, _valid) in enumerate(iterate_batches(
            data, net.config["batchsize"])):
        if i >= num_batches:
            break
        batch = {k: v for k, v in batch.items() if k != "labels"}
        generator = torch.Generator(device=net.device)
        generator.manual_seed(0)
        with torch.inference_mode():
            # every rank of a distributed model calibrates on the whole
            # batch; its variables may be channel shards
            ctx = Ctx(net.variables, compute_dtype=net.compute_dtype,
                      kernel_cache=net._kernel_cache, generator=generator,
                      calibrate=True, calibrate_percentile=percentile,
                      tensor_parallel=net._parallel_ctx().get(
                          "tensor_parallel"))
            net._test_outputs(ctx, net._preprocess(
                net._batch_to_device(batch)))
        for key, value in ctx.amax.items():
            value = float(value)
            running[key] = max(running.get(key, 0.0), value)
    if not running:
        raise ValueError("calibration saw no batches / no convs")
    return running


def select_scales(amax, variables, min_channels=128, min_pixels=2048,
                  packed_stem_prefixes=None):
    """Turn calibrated amaxes into activation scales (``amax / 127``) for
    the eligible convs.

    Eligibility, as in the JAX package:
      * the conv kernel's input-channel count (``<scope>/kernel``
        shape[2]) is at least ``min_channels``;
      * the conv input's spatial extent (``<scope>/input_pixels`` from
        calibration) is at least ``min_pixels``; a conv without that
        record (a scales dict written by hand) stays eligible;
      * the amax is finite and positive.

    ``packed_stem_prefixes``: the expert prefixes whose FCN stems run
    through the packed stem (``models/packed_experts.py``). Their
    conv1_2/conv2_1 are judged at the summed input width of all experts,
    and their scales go under ``packed:<scope>/input_amax`` keys, which
    only the packed stem reads: an unpacked 64-in stem conv never picks
    one up. A packed stem conv is int8 for all experts or for none. The
    packing gates the caller cannot see from a batch are mirrored from
    the variables and the calibration record: every prefix's conv1_1 takes
    at most 4 input channels, and all experts share one input grid.
    """
    scales = {}
    packed_stem_prefixes = list(packed_stem_prefixes or ())

    def packing_applies():
        """Mirror can_pack_stems' batch-shape gates from stored state."""
        if len(packed_stem_prefixes) < 2:
            return False
        grids = set()
        for prefix in packed_stem_prefixes:
            kernel = variables.get(f"{prefix}/conv1_1/kernel")
            if kernel is None or int(kernel.shape[2]) > 4:
                return False
            pixels = amax.get(f"{prefix}/conv1_1/input_pixels")
            if pixels is not None:
                grids.add(float(pixels))
        return len(grids) <= 1

    if not packing_applies():
        packed_stem_prefixes = []

    def packed_in_channels(name):
        total = 0
        for prefix in packed_stem_prefixes:
            kernel = variables.get(f"{prefix}/{name}/kernel")
            if kernel is None:
                return 0
            total += int(kernel.shape[2])
        return total

    for key, value in amax.items():
        if not key.endswith("/input_amax"):
            continue
        scope = key.rsplit("/", 1)[0]
        kernel = variables.get(scope + "/kernel")
        if kernel is None or kernel.ndim != 4:
            continue
        in_ch = int(kernel.shape[2])
        prefix, _, name = scope.rpartition("/")
        packed = prefix in packed_stem_prefixes and name in PACKED_STEM_CONVS
        if packed:
            in_ch = packed_in_channels(name)
        if in_ch < min_channels:
            continue
        pixels = amax.get(scope + "/input_pixels")
        if pixels is not None and pixels < min_pixels:
            continue
        if value <= 0.0 or not math.isfinite(value):
            continue
        scales[("packed:" + key) if packed else key] = value / 127.0
    # all-or-none per packed stem conv
    for name in PACKED_STEM_CONVS:
        keys = [f"packed:{p}/{name}/input_amax"
                for p in packed_stem_prefixes]
        if keys and not all(k in scales for k in keys):
            for k in keys:
                scales.pop(k, None)
    return scales
