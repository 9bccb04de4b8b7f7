#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card (an
H100) and the CUDA toolkit. Phases, each printing its own lines:

 1. device: the card's name, the device count and nvidia-smi's name and
    power limit;
 2. build: the three kernels of ``modular_semantic_segmentation_torch/
    csrc``, one nvcc each, in parallel; ptxas's registers, shared memory
    and spills for each, and the count of HGMMA (wgmma) instructions in
    the stem conv's machine code, which must not be 0; then the host
    library of the input pipeline (``native/host_ops.cc``, g++);
 3. kernel checks: the confusion kernel, both entry points, exact against
    its plain version, on uniform pairs (with -1 and out-of-range labels
    and predictions) and on one bin, timed with its yardstick
    (``torch.add`` of the same bytes) and ``torch.bincount``; the
    Dirichlet kernel against its plain version (f32 and bf16
    probabilities, each expert's in its own tensor, read in place;
    labels equal except at argmax ties) at the flagship shapes (768x384
    frames, 14 classes); the stem conv kernel against its plain version
    at conv1_2, conv2_1 and conv2_2 of the flagship ([1, 768, 384, 64] ->
    64, [1, 384, 192, 64] -> 128, [1, 384, 192, 128] -> 128) and at a
    ragged shape ([2, 37, 53, 16] -> 24), within 1e-2 of the largest plain
    value. Each is timed with CUDA events, L2 flushed before each call,
    beside its plain version, a PyTorch yardstick call where one exists
    (the stem conv's is cuDNN's conv), and its bound; the kernel and its
    yardstick in turns (yardstick, kernel, kernel, yardstick);
 4. measure step: two full-width SimpleFCN experts (rgb, depth; num_units
    64, 14 classes, seeded weights) score 4 seeded frames with labels;
 5. Dirichlet fit: DirichletFusion.fit on those 4 frames (float32
    experts, sufficient statistics on the card, EM on the host);
 6. Bayes serving: BayesFusion on the measured confusion matrices,
    bfloat16, InferenceServer(unroll=4) over 8 frames;
 7. Dirichlet serving: the fitted DirichletFusion(use_pallas=True),
    bfloat16, 8 frames, with no torch.stack on the path (the kernel reads
    the experts' probabilities in place);
 8. stem conv: the stem conv kernel as conv1_2 of the rgb expert, fed the
    expert's own conv1_1 output (bf16) on a served frame, held against
    the expert's conv1_2 layer;
 9. the confusion kernel on the measure step's own pairs (the measure
    frames' labels and the rgb expert's predictions; its record), and the
    measure step's device kernels per scored batch (torch.profiler);
10. fusion family: Average, Variance (10 samples, dropout 0.5),
    Uncertainty-Dirichlet (10 samples, dropout 0.2, the parameters of
    phase 5) and BayesianFCN (the rgb expert's weights, 10 samples) at
    full width in bf16, each scoring the 4 frames through the confusion
    kernel and serving 2 frames; at dropout 0 in float32, Variance gives
    Average's labels up to ties, Uncertainty-Dirichlet Dirichlet's score
    and BayesianFCN the expert's entropy with no variance; how often bf16
    and f32 fused labels agree on a served frame;
11. int8 serving: the flagship calibrated on the 4 measure frames and
    quantized (``quantize_for_serving``; the convs that went int8 per
    expert printed); the int8 product (im2col + ``torch._int_mm``) exact
    against its plain version at conv1_2 (packed key), conv2_2, conv3_2,
    conv4_2, conv5_1 and score_conv5 of the rgb expert, each timed
    (quantize, im2col, ``_int_mm``) beside cuDNN's bf16 conv of the same
    layer; Bayes and Dirichlet (kernel B) served in int8 in turns with
    bf16, with the share of fused labels on which they agree; ``score``
    in int8 (kernel A); a traced int8 group; and ``dequantize_serving``
    giving back the bf16 outputs bit for bit;
12. a traced run of each serving path: device time by kernel, busy and
    idle share per frame (traces in traces/, gitignored);
13. training: the flagship's rgb expert (SimpleFCN, batch norm, adam,
    batch 1, 768x384) fitted for 20 steps on 4 frames whose labels are
    the red channel of 32x32 blocks quantized to the 14 classes (a void
    border), in float32 and in bf16, validated on 2 held-out frames every
    5 steps (``score``, kernel A, its counts held against the plain
    version); then BayesianFCN (the float32 run's weights, dropout 0.5)
    for 3 steps. Gates: finite losses, the last below the first (the two
    20-step runs), the frozen deconv kernels bit for bit, the BN moving
    statistics moved. Printed: ms per train step (median after 2 warm-up
    steps, host clock around synchronised steps), peak memory, the
    losses, kernel A's launches, and a traced bf16 step by kernel;
14. other architectures, at the flagship's width (768x384, 14 classes,
    ``num_units`` 64, seeded weights): two AdapNet experts (rgb, depth)
    score the 4 measure frames in float32 (kernel A, its counts held
    against the plain version); Bayes (those matrices), Dirichlet
    (``use_pallas``, fitted on the frames; kernel B's labels held against
    its plain version) and Average fusions of them serve 4 frames in bf16
    (ms/frame), bf16 against float32 fused labels, a traced Bayes-AdapNet
    group (the Dirichlet fit's EM on these random experts is bounded to
    ADAPNET_EM_ITERATIONS iterations a class); AdapNet (rgb, adam) trained
    10 steps in
    float32 and in bf16, FusionFCN (rmsprop) and ProgressiveFCN (depth
    column, rgb lateral) 5 bf16 steps each, validated through kernel A
    (gates: the loss over the training frames falls, AdapNet's upconvs
    change, the frozen variables and the lateral column stay bit for
    bit, the adapter scales move); on 64x96 against the CPU, a float32
    Bayes-AdapNet forward and one float32 SGD(1.0) AdapNet step with
    batch norm from fixed statistics (the two-limit gate of phase 15), and
    the train-mode step's loss and moving-statistic updates (a TF32
    control step must fail both limits; its trainable deltas' distance
    from float64 printed, not gated); at 768x384, the train-mode step's
    float32 deltas against float64 on the card (printed, not gated);
15. reference checks on a small input, the CUDA path against the plain
    versions on the CPU; among them one float32 SGD(1.0) train step on
    the card against the CPU's and against float64 on the card, each max
    pool's routes recorded, and a TF32 control step that must fail;
16. the experiment pipeline, through the port's CLIs in-process (the
    shim's ``Experiment.run``) in a temporary experiment store, on
    ``UnittestData(complementary=True)`` at 768x384 (5 classes):
    ``training`` of the rgb and the depth expert (SimpleFCN, num_units 64,
    batch norm, adam, batch 2, 20 steps on 4 frames, validated through
    kernel A), ``evaluation`` of each run, ``bayes_fusion`` and
    ``dirichlet_fusion`` (``use_pallas``, kernel B) ``fit_and_evaluate``
    (its EM bounded to PIPELINE_EM_ITERATIONS iterations a class), then
    BayesFusion(eval_experiments=...) and
    DirichletFusion(measurement_exp=..., use_pallas=True) serve 4 frames
    in bf16. Gates: every score's counts equal kernel A's plain version's,
    every kernel B label a tie of its plain version's scores, both
    kernels launched, every record (and the zip ``dump`` writes of it)
    reads back, and the record-loaded fusions serve the labels of models
    built from the same arrays. Printed: each run's seconds, ms/frame
    served, each expert's and fusion's mean IoU;
17. the training input pipeline: 8 raw SYNTHIA frames of 1280x760 (RGB,
    16-bit crude depth, 14-class crude labels that are a learnable
    function of the rgb) written with the port's PNG writer into a
    temporary tree, ``get_dataset('synthia')`` preprocessing them
    (seconds per frame) and decoding and assembling batches of 4 with one
    worker and with one per core (frames/s); the rgb SimpleFCN (num_units
    64, batch norm, adam 1e-3, batch 4) trained 10 steps at 640x368 with
    ``loader_workers`` and the prefetching loader, with the on-device
    augmentation ``scale=(0.4, 0.7, 1.5), hflip=0.5, gamma=(0.4, 0.3,
    1.2), crop=(1.0, 368)`` and without, validated on the measure set
    every 5 steps and scored on the test set (kernel A, counts held
    against its plain version); ms per step, peak memory, a traced
    augmented step (idle share, top kernels; trace in
    ``traces/input_pipeline/``), fit's loop by hand (the wait for each
    batch beside the step: prefetched with one worker per core and with
    one, and assembled in the loop without the prefetcher), and the
    device augmentation of a batch of 4 on the separable path and on the
    general one (rotate and shear).
    Gates: finite losses, augmented labels in [-1, K), the card's warps
    equal the CPU's for the same maps (nearest exact, bilinear uint8
    exact except rounding ties, counted), the prefetcher re-raises an
    exception injected into its producer, and kernel A's launches equal
    the phase's validation and score batches;
18. the experiment surface, in-process in a temporary store: the timing
    CLI's ``main`` at its defaults (768x384, num_units 64, 14 classes,
    bf16) with 10 repetitions (the paper's Table V sweep),
    ``time_adapnet`` and ``time_bayes_adapnet`` in bf16 and int8,
    ``time_serving`` (Bayes bf16 and int8, Bayes-AdapNet int8),
    ``time_train_step`` (SimpleFCN and AdapNet, batch 1) and
    ``time_offline_eval`` (16 frames, batch 8); ``report``'s Table V of
    the ``main`` run beside the paper's GTX 1080 Ti figures; Bayes-AdapNet
    in bf16 and int8 on one seeded frame (its int8 convs, ``_int_mm``
    launches, label agreement); then, every score's counts held against
    kernel A's plain version: ``uncertainty_eval``'s
    ``uncertainty_benchmark`` (out_of_distribution, entropy) on
    ``add_random_objects`` over 768x384 UnittestData (8 classes, an object
    library written by the phase) and ``measure``, with a seeded
    full-width BayesianFCN; ``training`` of the rgb and depth SimpleFCN
    (2 steps), ``finetuning rgb_to_depth`` of the rgb run (2 steps), a
    FusionFCN step and ``train_and_evaluate_progressive rgb_to_depth``
    from it (2 steps; the lateral column's first kernel the translated
    one), and ``ibcc_fusion`` of the two experts. Gates: the int8 AdapNet
    rows and the seeded frame launched ``_int_mm``, the AUROC in [0, 1],
    finite NLL, the translated kernels, the IBCC labels' shapes and
    range, kernel A launched.

The launch counts are set to 0 just before phase 4 and read just after
phase 7 (confusion and Dirichlet kernels), set to 0 just before and read
just after phase 8 (stem conv), phase 10 (confusion kernel), the int8
path of phase 11 (confusion and Dirichlet kernels, ``_int_mm``), phase
13 (confusion kernel), phase 14's serving path (confusion and
Dirichlet kernels) and training path (confusion kernel), phase 16
(confusion and Dirichlet kernels), phase 17 (confusion kernel) and
phase 18 (confusion kernel). The
third-to-last line is the int8 product's JSON record (a library call,
not a kernel of the port), the second-to-last the kernels' and the last
``{"ok": true, "device": {...}}``. Any fault exits non-zero with no
result line; so does a machine without a CUDA card.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HEIGHT, WIDTH = 768, 384
NUM_CLASSES = 14
NUM_UNITS = 64
MEASURE_FRAMES = 4
SERVE_FRAMES = 8
UNROLL = 4
# H100 SXM, NVIDIA's data sheet: HBM rate, the float32 rate outside the
# tensor cores and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# the stem conv probe, (batch, height, width, cin, cout): conv1_2, conv2_1
# and conv2_2 of the flagship expert (timed; conv1_2 is the kernel's
# record) and a ragged shape (checked only)
STEM_SHAPES = ((1, HEIGHT, WIDTH, 64, 64),
               (1, HEIGHT // 2, WIDTH // 2, 64, 128),
               (1, HEIGHT // 2, WIDTH // 2, 128, 128), (2, 37, 53, 16, 24))
STEM_TIMED = 3
STEM_RTOL = 1e-2
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "traces")
TIE_RTOL = 1e-5
# the float32 train step on the card against the CPU and against float64:
# the loss, each tensor's delta over its scale, and the tensors that no
# max pool routing its gradient differently reaches (arithmetic alone)
STEP_LOSS_RTOL = 1e-5
STEP_ATOL = 1e-3
ARITHMETIC_ATOL = 1e-5
MODALITIES = ("rgb", "depth")
DATA_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)},
    NUM_CLASSES)


class SmokeFailure(Exception):
    pass


def _ms(value):
    return "not measured" if value is None else f"{value:.4f} ms"


def _runs(times):
    return " / ".join(f"{t:.3f}" for t in times)


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def bound_ms(n_bytes, n_ops=0.0, ops_per_s=F32_FLOPS_PER_S):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def phase_device():
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} | device_count {count} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi_line}")
    return name, count, smi_line


def ptxas_usage(log):
    """[(kernel, 'registers, shared memory, spills')] from nvcc's -Xptxas -v
    output; a template instance is named by its arguments, e.g.
    ``dirichlet_label_kernel<bf16, 14, 14>``."""
    out, function, spills = [], None, ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            mangled = found.group(1)
            named = re.search(r"\d+([a-z_]+_kernel)", mangled)
            base = named.group(1) if named else mangled
            args = re.search(r"_kernelI(13__nv_bfloat16|f)((?:Li\d+E)+)",
                             mangled)
            function = base if args is None else "{}<{}>".format(
                base, ", ".join(["f32" if args.group(1) == "f" else "bf16"]
                                + re.findall(r"\d+", args.group(2))))
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and function is not None:
            out.append((function, f"{line.split(':', 1)[1].strip()}; "
                                  f"{spills}"))
            function = None
    return out


def phase_build():
    from modular_semantic_segmentation_torch.datasets import native_backend
    from modular_semantic_segmentation_torch.ops.cuda import build
    start = time.perf_counter()
    build.build()
    print(f"build: {', '.join(build.KERNEL_SOURCES)} with nvcc in "
          f"{time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    native_backend.build()
    print(f"build: the host library native/host_ops.cc with the host's C++ "
          f"compiler in {time.perf_counter() - start:.1f} s")
    for name in build.KERNEL_SOURCES:
        for function, usage in ptxas_usage(build.build_log(name)):
            print(f"ptxas {function}: {usage}")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", build.library_path("stem_conv")[1]],
        capture_output=True, text=True, timeout=120, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"stem_conv machine code: {hgmma} HGMMA instructions")
    check(hgmma > 0, "the stem conv kernel issues no wgmma (HGMMA)")


def confusion_pairs(kind, pixels=HEIGHT * WIDTH, seed=0):
    """(predictions, labels), int32 on the card, as the main path gives
    them: 'uniform' pairs with values outside [0, K), or 'one bin'
    (every pixel label 3 and prediction 3)."""
    if kind == "one bin":
        full = torch.full((pixels,), 3, dtype=torch.int32, device="cuda")
        return full, full.clone()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    preds = torch.randint(-1, NUM_CLASSES + 2, (pixels,), generator=gen,
                          device="cuda", dtype=torch.int32)
    labels = torch.randint(-2, NUM_CLASSES + 3, (pixels,), generator=gen,
                           device="cuda", dtype=torch.int32)
    return preds, labels


def check_confusion(card, kind, preds, labels,
                    timed_pixels=HEIGHT * WIDTH):
    """Kernel A on one distribution: both entry points exact against the
    plain version over all the pairs; then, on the first ``timed_pixels``
    (one frame's), times after the 1 GiB L2 flush: the accumulating call
    (one launch), the kernel alone, the drop-in ``confusion_matrix``, the
    plain version, ``torch.bincount`` of the valid bin indices, and
    ``torch.add`` of labels and predictions (the same bytes read); the
    call and the yardstick in turns (yardstick, call, call, yardstick)."""
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    from modular_semantic_segmentation_torch.utils.profiling import (
        cold_ms, kernel_ms)
    k = NUM_CLASSES
    want = confusion.confusion_matrix_plain(preds, labels, k)
    got = confusion.confusion_matrix(preds, labels, k)
    total = confusion.confusion_accumulate(
        preds, labels, k, torch.zeros((k, k), dtype=torch.int64,
                                      device="cuda"))
    torch.cuda.synchronize()
    err = max(float((got - want).abs().max()),
              float((total.float() - want).abs().max()))
    check(err == 0 and total.dtype == torch.int64,
          f"confusion kernel ({kind}) differs from its plain version by "
          f"{err}")
    valid = ((labels >= 0) & (labels < k) & (preds >= 0) & (preds < k))
    check(int(total.sum()) == int(valid.sum()),
          f"confusion kernel ({kind}) counted the wrong number of pixels")
    preds, labels = preds[:timed_pixels], labels[:timed_pixels]
    valid = valid[:timed_pixels]
    index = (labels[valid].long() * k + preds[valid]).contiguous()

    def call():
        confusion.confusion_accumulate(preds, labels, k, total)

    yard = [cold_ms(lambda: torch.add(preds, labels))]
    ms = [cold_ms(call), cold_ms(call)]
    yard.append(cold_ms(lambda: torch.add(preds, labels)))
    alone = kernel_ms(call, "confusion_kernel")
    matrix = cold_ms(lambda: confusion.confusion_matrix(preds, labels, k))
    plain = cold_ms(lambda: confusion.confusion_matrix_plain(preds, labels,
                                                             k))
    library = cold_ms(lambda: torch.bincount(index, minlength=k * k))
    n_bytes = (preds.numel() * preds.element_size()
               + labels.numel() * labels.element_size() + 2 * k * k * 8)
    bound, bound_by = bound_ms(n_bytes)
    bins = int((confusion.confusion_counts_plain(preds, labels, k)
                > 0).sum())
    print(f"kernel confusion, {kind} ({len(preds)} pixels a call, {bins} "
          f"bins hit): exact vs plain (both entry points, "
          f"{int(valid.sum())} counted); call {_runs(ms)} ms (one launch; "
          f"kernel alone {_ms(alone)}), confusion_matrix {matrix:.4f} ms, "
          f"plain {plain:.4f} ms, bincount {library:.4f} ms, torch.add of "
          f"labels and predictions {_runs(yard)} ms, bound {bound:.4f} ms "
          f"({bound_by}) on {card}")
    return {"name": "confusion", "route": "cuda",
            "source": "modular_semantic_segmentation_torch/csrc/"
                      "confusion.cu",
            "replaces": "modular_semantic_segmentation_tpu/ops/pallas/"
                        "confusion_kernel.py:42",
            "max_abs_err": err, "ms": sum(ms) / len(ms), "kernel_ms": alone,
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library}


def measure_step_launches(expert, frames, card):
    """Device kernels and memsets of ``expert.score`` over the frames
    against those of its forward passes alone (torch.profiler), per
    scored batch; and kernel A's share of the score's device time. Kernel
    A's launches are counted by its wrapper; a trace that holds fewer
    kernel launches than the forward passes' is incomplete (a trace on an
    H100 once held a fifth of the score's kernels) and is reported as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    from modular_semantic_segmentation_torch.utils.data_io import \
        iterate_batches

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("Memcpy")}

    def forwards():
        for batch, _ in iterate_batches(frames, expert.config["batchsize"]):
            expert._forward(expert._batch_to_device(batch))

    batches = len(frames["labels"]) // expert.config["batchsize"]
    before = confusion.KERNEL.launches
    scored = kernels(lambda: expert.score(frames))
    a_launches = confusion.KERNEL.launches - before
    check(a_launches == batches, f"the measure step launched kernel A "
          f"{a_launches} times for {batches} batches")
    forward = kernels(forwards)
    extra = {key: count - forward.get(key, (0, 0))[0]
             for key, (count, _) in scored.items()}
    extra = {key: n for key, n in extra.items() if n}
    a_count, a_us = scored.get(next(
        (key for key in scored if "confusion_kernel" in key), ""), (0, 0))
    device_us = sum(us for _, us in scored.values())
    traced = sum(n for n, _ in scored.values())
    if device_us <= 0 or traced < sum(n for n, _ in forward.values()):
        print(f"measure step, {expert.modality} expert: kernel A launched "
              f"{a_launches} times for {batches} scored batches (its "
              f"counter); the trace's breakdown not measured ({traced} "
              f"kernel launches traced, fewer than the forward passes')")
        return
    print(f"measure step, {expert.modality} expert, {batches} scored "
          f"batches (torch.profiler): {a_count / batches:.2f} confusion "
          f"launches a batch; kernels and memsets beyond the forward "
          f"passes' "
          f"{sum(extra.values()) / batches:.2f} a batch ("
          + ", ".join(f"{key[:60]} x{n}" for key, n in sorted(extra.items()))
          + f"); kernel A {a_us / 1e3 / batches:.4f} ms of "
          f"{device_us / 1e3 / batches:.3f} ms device time a batch "
          f"({100 * a_us / device_us:.3f}%) on {card}")
    check(a_count == batches, f"the measure step's trace holds kernel A "
          f"{a_count} times for {batches} batches")


def check_dirichlet(card):
    from modular_semantic_segmentation_torch.ops.cuda import dirichlet
    from modular_semantic_segmentation_torch.utils.profiling import (
        cold_ms, kernel_ms)
    k, pixels, experts = NUM_CLASSES, HEIGHT * WIDTH, 2
    rng = np.random.RandomState(0)
    probs = np.stack([rng.dirichlet(np.ones(k), size=pixels)
                      for _ in range(experts)]).astype(np.float32)
    alphas = [rng.rand(k, k) * 4 + 0.5 for _ in range(experts)]
    prior = rng.dirichlet(np.ones(k))
    # the kernel takes its constants by value, from the host; the plain
    # version computes on the card
    host = [torch.from_numpy(t) for t in dirichlet.dirichlet_tables(
        alphas, prior, 1.0, k)]
    coeffs, bias = (t.cuda() for t in host)
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        # each expert's probabilities in a tensor of its own, as the model
        # passes them: the kernel reads them in place
        in_place = [torch.from_numpy(p).to("cuda", dtype) for p in probs]
        stacked = torch.stack(in_place)  # for the plain version only
        got = dirichlet.dirichlet_label(in_place, *host)
        scores = dirichlet.dirichlet_scores_plain(stacked, coeffs, bias)
        want = torch.argmax(scores, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        best = scores.max(dim=-1).values
        picked = scores.gather(1, got.long()[:, None])[:, 0]
        gap = best - picked
        differ = got != want
        n_differ = int(differ.sum())
        rel = gap / best.abs().clamp_min(1e-30)
        check(bool((rel[differ] <= TIE_RTOL).all()),
              f"dirichlet kernel ({dtype}) picks labels that are not ties "
              f"of the plain scores: max relative gap {float(rel.max())}")
        ms = cold_ms(lambda: dirichlet.dirichlet_label(in_place, *host))
        alone = kernel_ms(lambda: dirichlet.dirichlet_label(in_place, *host),
                          "dirichlet_label_kernel")
        plain = cold_ms(lambda: dirichlet.dirichlet_label_plain(
            stacked, coeffs, bias))
        # what reading the same bytes costs after the L2 flush: the
        # simplest op that reads both experts' probabilities
        read_ms = cold_ms(lambda: torch.add(*in_place))
        n_bytes = (stacked.numel() * stacked.element_size() + pixels * 4
                   + (coeffs.numel() + bias.numel()) * 4)
        n_ops = experts * pixels * (k + 2 * k * k) + pixels * k
        bound, bound_by = bound_ms(n_bytes, n_ops)
        print(f"kernel dirichlet {str(dtype)[6:]}, experts read in place: "
              f"{n_differ} of {pixels} labels differ from plain, all ties "
              f"within rel {TIE_RTOL}; max score gap "
              f"{float(gap.max()):.3g}; call {ms:.4f} ms (kernel alone "
              f"{_ms(alone)}), plain {plain:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by}), torch.add of the experts (the same bytes "
              f"read) {read_ms:.4f} ms on {card}")
        # the record keeps the dtype the main path serves: bfloat16
        record = {"name": "dirichlet", "route": "cuda",
                  "source": "modular_semantic_segmentation_torch/csrc/"
                            "dirichlet.cu",
                  "replaces": "modular_semantic_segmentation_tpu/ops/"
                              "pallas/dirichlet_kernel.py:52",
                  "max_abs_err": float(gap.max()), "ms": ms,
                  "kernel_ms": alone, "plain_ms": plain, "bound_ms": bound,
                  "bound_by": bound_by, "library_ms": None}
    return record


def check_stem_conv(card):
    from modular_semantic_segmentation_torch.ops.cuda import stem_conv
    record = None
    for i, (batch, h, w, cin, cout) in enumerate(STEM_SHAPES):
        full = i < STEM_TIMED
        out = stem_conv.probe(h, w, cin, cout, batch=batch, timings=full)
        check(out["max_abs_err"] <= STEM_RTOL * out["scale"],
              "stem conv kernel differs from its plain version")
        shape = f"[{batch}, {h}, {w}, {cin}] -> {cout}"
        if not full:
            print(f"kernel stem_conv {shape}: max|kernel - plain| "
                  f"{out['max_abs_err']:.4g} of max|plain| "
                  f"{out['scale']:.4g} (limit {STEM_RTOL} of it) on {card}")
            continue
        bound, bound_by = bound_ms(out["n_bytes"], out["n_flops"],
                                   BF16_FLOPS_PER_S)
        print(f"kernel stem_conv {shape}: max|kernel - plain| "
              f"{out['max_abs_err']:.4g} of max|plain| {out['scale']:.4g} "
              f"(limit {STEM_RTOL} of it); call {out['ms']:.4f} ms (kernel "
              f"alone {_ms(out['kernel_ms'])}), plain {out['plain_ms']:.4f} "
              f"ms, cuDNN conv+bias+relu {out['library_ms']:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}: {out['n_bytes'] / 1e6:.2f} MB, "
              f"{out['n_flops'] / 1e9:.2f} GFLOP) on {card}")
        if i:
            continue
        record = {"name": "stem_conv", "route": "cuda",
                  "source": "modular_semantic_segmentation_torch/csrc/"
                            "stem_conv.cu",
                  "replaces": "scripts/pallas_stem_conv_probe.py:129",
                  "max_abs_err": out["max_abs_err"], "ms": out["ms"],
                  "kernel_ms": out["kernel_ms"],
                  "plain_ms": out["plain_ms"], "bound_ms": bound,
                  "bound_by": bound_by, "library_ms": out["library_ms"]}
    return record


def make_frames(seed, count):
    rng = np.random.RandomState(seed)
    return {
        "rgb": (rng.rand(count, HEIGHT, WIDTH, 3) * 255).astype(np.float32),
        "depth": rng.rand(count, HEIGHT, WIDTH, 1).astype(np.float32),
        "labels": rng.randint(-1, NUM_CLASSES,
                              (count, HEIGHT, WIDTH)).astype(np.int32)}


def build_experts(device="cuda"):
    from modular_semantic_segmentation_torch.models import get_model
    return {m: get_model("simple_fcn")(
        prefix=m, data_description=DATA_DESCRIPTION, modality=m,
        num_units=NUM_UNITS, batch_normalization=False, seed=i,
        device=device) for i, m in enumerate(MODALITIES)}


def fusion_model(name, experts, device="cuda", expert_model="fcn",
                 **config):
    from modular_semantic_segmentation_torch.models import get_model
    net = get_model(name)(
        data_description=DATA_DESCRIPTION, num_units=NUM_UNITS,
        expert_model=expert_model, prefixes={m: m for m in MODALITIES},
        batchsize=1, device=device, **config)
    for expert in experts.values():
        net.variables.update(
            {k: v.to(net.device) for k, v in expert.variables.items()})
    return net


def serve(net, frames, repeats=3):
    """ms per frame of InferenceServer(unroll=4) over the frames, for each
    of ``repeats`` runs after a warm-up run (which also fills PyTorch's
    caches of pinned host and device memory); returns (outputs, times)."""
    from modular_semantic_segmentation_torch.serving import InferenceServer
    server = InferenceServer(net, unroll=UNROLL)
    server.predict(frames)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = server.predict(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3 / len(frames))
    return out, times


def serving_profile(net, frames, label):
    """Device time by kernel over one served group, from torch.profiler
    (a separate, traced run: the timed runs are untraced). The trace is
    written to traces/<label>/trace.json."""
    from torch.autograd import DeviceType
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils.profiling import trace
    server = InferenceServer(net, unroll=UNROLL)
    group = frames[:UNROLL]
    torch.cuda.synchronize()
    with trace(os.path.join(TRACE_DIR, label.lower())) as prof:
        start = time.perf_counter()
        server.predict(group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3 / len(group)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f"{label} profile: not measured (no device time recorded)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / len(group)
    print(f"{label} profile, traced, per frame: device busy {busy:.3f} ms "
          f"of {wall:.3f} ms wall, idle share {1 - busy / wall:.2f}; top "
          f"kernels (ms per frame, launches per frame, name):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / len(group):8.3f} "
              f"x{e.count / len(group):5.1f}  {e.key[:100]}")


def fit_dirichlet(net, frames, card, what="Dirichlet fit"):
    """DirichletFusion.fit on the measure frames, once, timing its two
    halves as it runs them: the sufficient statistics (device time from
    torch.profiler, the fit's only device work, and the host clock) and
    the EM (host clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    host_ms = {}

    def clocked(name, method):
        def run(*args):
            start = time.perf_counter()
            out = method(*args)
            torch.cuda.synchronize()
            host_ms[name] = (time.perf_counter() - start) * 1e3
            return out
        return run

    net._get_sufficient_statistic = clocked(
        "stats", net._get_sufficient_statistic)
    net._fit_sufficient_statistic = clocked(
        "em", net._fit_sufficient_statistic)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params = net.fit(frames)
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    stats_ms, em_ms = host_ms["stats"], host_ms["em"]
    labels = frames["labels"]
    histogram = np.bincount(labels[labels >= 0], minlength=NUM_CLASSES)
    for m in MODALITIES:
        check(params[m].shape == (NUM_CLASSES, NUM_CLASSES),
              f"{m}: fitted parameters of shape {params[m].shape}")
        check(np.isfinite(params[m]).all() and (params[m] > 0).all(),
              f"{m}: fitted Dirichlet parameters not finite and positive")
    check(np.array_equal(params["class_counts"], histogram),
          f"Dirichlet fit: class counts {params['class_counts']} differ "
          f"from the label histogram {histogram}")
    device = ("not measured" if device_us <= 0
              else f"{device_us / 1e3:.3f} ms")
    print(f"{what} over {len(labels)} frames at {HEIGHT}x{WIDTH}: "
          f"sufficient statistics device time {device} (torch.profiler), "
          f"{stats_ms:.1f} ms host clock; EM {em_ms:.1f} ms host clock "
          f"({net.config['estimator']}, {NUM_CLASSES} classes x "
          f"{len(MODALITIES)} experts); parameters finite and > 0 (range "
          f"{min(params[m].min() for m in MODALITIES):.4g} .. "
          f"{max(params[m].max() for m in MODALITIES):.4g}), class counts "
          f"equal the label histogram; on {card}")
    return params


def stem_conv_path(expert, frames, card):
    """The stem conv kernel as conv1_2 of ``expert`` (no batch norm, as
    the fusion experts have it): fed the expert's own bf16 conv1_1 output
    on one frame, held against the expert's conv1_2 layer output."""
    from modular_semantic_segmentation_torch.models.simple_fcn import \
        encoder_stem
    from modular_semantic_segmentation_torch.ops.cuda import stem_conv
    from modular_semantic_segmentation_torch.ops.variables import Ctx
    m = expert.modality
    batch = expert._preprocess(expert._batch_to_device(
        {m: frames[m][:1]}))
    with torch.inference_mode():
        ctx = Ctx(expert.variables, compute_dtype=torch.bfloat16,
                  kernel_cache=expert._kernel_cache)
        layers = encoder_stem(ctx, batch[m], m, batchnorm=False)
        kernel = expert.variables[f"{m}/conv1_2/kernel"]
        bias = expert.variables[f"{m}/conv1_2/bias"]
        got = stem_conv.stem_conv_nhwc(layers["conv1_1"], kernel, bias)
    torch.cuda.synchronize()
    want = layers["conv1_2"].float()
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    check(tuple(got.shape) == tuple(want.shape),
          f"stem conv path: shape {tuple(got.shape)}, the layer's "
          f"{tuple(want.shape)}")
    check(err <= STEM_RTOL * scale, f"stem conv path: kernel differs from "
          f"the {m} expert's conv1_2 by {err} (max {scale})")
    print(f"stem conv path: {m} conv1_2 {tuple(got.shape)} through the "
          f"kernel, max|kernel - expert layer| {err:.4g} of max {scale:.4g}"
          f" (limit {STEM_RTOL} of it) on {card}")


def forward(net, frame):
    """All test outputs of ``net`` on one frame, on the card."""
    return net._forward(net._batch_to_device({k: v[:1]
                                              for k, v in frame.items()}))


def tie_gaps(scores, labels, other):
    """Where ``labels`` and ``other`` differ: the relative gap between the
    scores of the two labels (0 where they agree)."""
    scores = scores.float()
    a = scores.gather(-1, labels.long()[..., None])[..., 0]
    b = scores.gather(-1, other.long()[..., None])[..., 0]
    return ((a - b).abs() / a.abs().clamp_min(1e-30)) * (labels != other)


def fusion_family(experts, frames, params, cms, card):
    """The rest of the paper's fusion family at full width: each model
    scores the measure frames through kernel A and serves 2 frames;
    consistency checks at dropout 0 in float32 (cuDNN restricted to
    deterministic algorithms, so repeated passes are equal); the variance
    maps at the stated rates finite and not all zero; and how often the
    bf16 and f32 fused labels agree on a served frame."""
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.ops import layers as ll
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    from modular_semantic_segmentation_torch.serving import InferenceServer

    def bayesian(**config):
        net = get_model("bayesian_fcn")(
            prefix="rgb", modality="rgb", data_description=DATA_DESCRIPTION,
            num_units=NUM_UNITS, batch_normalization=False, num_samples=10,
            device="cuda", **config)
        net.variables = dict(experts["rgb"].variables)
        return net

    family = {
        "Average": fusion_model("average_fusion", experts,
                                compute_dtype="bfloat16"),
        "Variance": fusion_model("variance_fusion", experts, num_samples=10,
                                 dropout_rate=0.5, compute_dtype="bfloat16"),
        "Uncertainty-Dirichlet": fusion_model(
            "uncertainty_dirichlet_mix", experts, num_samples=10,
            dropout_rate=0.2, dirichlet_params=params,
            compute_dtype="bfloat16"),
        "BayesianFCN": bayesian(compute_dtype="bfloat16"),
    }
    maps = {"Variance": ("rgb_variance", "depth_variance"),
            "Uncertainty-Dirichlet": ("rgb_uncertainty", "depth_uncertainty"),
            "BayesianFCN": ("variance", "entropy", "cond_entropy")}
    served = [{"rgb": frames["rgb"][i], "depth": frames["depth"][i]}
              for i in range(2)]
    labelled = int(((frames["labels"] >= 0)
                    & (frames["labels"] < NUM_CLASSES)).sum())
    for name, net in family.items():
        before = confusion.KERNEL.launches
        measures, cm = net.score(frames)
        launches = confusion.KERNEL.launches - before
        check(cm.sum() == labelled and np.isfinite(measures["mean_F1"]),
              f"{name}: score counted {cm.sum()} of {labelled} pixels")
        check(launches > 0, f"{name}: score launched no confusion kernel")
        server = InferenceServer(net, unroll=2)
        labels = server.predict(served)
        check(labels.shape == (2, HEIGHT, WIDTH) and labels.dtype == np.int32
              and labels.min() >= 0 and labels.max() < NUM_CLASSES,
              f"{name}: served labels {labels.shape} {labels.dtype}")
        torch.cuda.synchronize()
        start = time.perf_counter()
        server.predict(served)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3 / len(served)
        out = forward(net, frames)
        spans = []
        for key in maps.get(name, ()):
            value = out[key].float()
            check(bool(torch.isfinite(value).all()) and bool(value.any()),
                  f"{name}: {key} not finite, or all zero")
            spans.append(f"{key} mean {float(value.mean()):.4g} max "
                         f"{float(value.max()):.4g}")
        print(f"fusion family {name}: score of {len(frames['labels'])} "
              f"frames mean_IoU {measures['mean_IoU']:.4f}, confusion "
              f"launches {launches}; {ms:.3f} ms/frame over 2 served frames "
              f"(bf16, unroll 2, after a warm-up; host clock, "
              f"synchronised)" + ("; " if spans else "") + "; ".join(spans)
              + f" on {card}")

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        average = forward(fusion_model("average_fusion", experts), frames)
        variance = forward(fusion_model(
            "variance_fusion", experts, num_samples=10, dropout_rate=0.0),
            frames)
        rel = tie_gaps(average["fused_score"], average["prediction"],
                       variance["prediction"])
        n_differ = int((variance["prediction"]
                        != average["prediction"]).sum())
        check(float(rel.max()) <= TIE_RTOL, "Variance at dropout 0 differs "
              f"from Average beyond ties: relative gap {float(rel.max())}")
        dirichlet = forward(fusion_model("dirichlet_fusion", experts,
                                         dirichlet_params=params), frames)
        uncertain = forward(fusion_model(
            "uncertainty_dirichlet_mix", experts, num_samples=10,
            dropout_rate=0.0, dirichlet_params=params), frames)
        scale = float(dirichlet["fused_score"].abs().max())
        ud_err = float((uncertain["fused_score"]
                        - dirichlet["fused_score"]).abs().max())
        check(ud_err <= 1e-4 * scale, "Uncertainty-Dirichlet at dropout 0 "
              f"differs from Dirichlet by {ud_err} (scale {scale})")
        bfcn = forward(bayesian(dropout_rate=0.0), frames)
        want = ll.entropy(forward(experts["rgb"], frames)["prob"])
        ent_err = float(((bfcn["entropy"] - want).abs()
                         / want.abs().clamp_min(1e-30)).max())
        bfcn_var = float(bfcn["variance"].abs().max())
        check(ent_err <= 1e-3 and bfcn_var < 1e-6, "BayesianFCN at dropout "
              f"0: entropy off by {ent_err} relative, variance {bfcn_var}")
        agree = []
        for name, f32, bf16 in (
                ("Bayes", fusion_model("bayes_fusion", experts,
                                       confusion_matrices=cms),
                 fusion_model("bayes_fusion", experts,
                              confusion_matrices=cms,
                              compute_dtype="bfloat16")),
                ("Dirichlet", fusion_model("dirichlet_fusion", experts,
                                           use_pallas=True,
                                           dirichlet_params=params),
                 fusion_model("dirichlet_fusion", experts, use_pallas=True,
                              dirichlet_params=params,
                              compute_dtype="bfloat16")),
                ("Average", None, family["Average"])):
            full = average if f32 is None else forward(f32, frames)
            same = full["prediction"] == forward(bf16, frames)["prediction"]
            agree.append(f"{name} {float(same.float().mean()):.4f}")
    finally:
        torch.backends.cudnn.deterministic = saved
    print(f"fusion family checks at dropout 0, float32, one frame: "
          f"Variance = Average labels ({n_differ} differ, all ties within "
          f"rel {TIE_RTOL}); Uncertainty-Dirichlet - Dirichlet score max "
          f"{ud_err:.3g} (limit 1e-4 x {scale:.4g}); BayesianFCN entropy "
          f"vs the rgb expert's max rel {ent_err:.3g} (limit 1e-3), "
          f"variance max {bfcn_var:.3g} (limit 1e-6); bf16 and f32 fused "
          f"labels agree on a served frame: {', '.join(agree)} on {card}")


# the int8 product checked and timed at the flagship's layers, on the rgb
# expert's own inputs: (layer, its input in the layer dict, key prefix)
INT8_LAYERS = (("conv1_2", "conv1_1", "packed:"), ("conv2_2", "conv2_1", ""),
               ("conv3_2", "conv3_1", ""), ("conv4_2", "conv4_1", ""),
               ("conv5_1", "pool4", ""), ("score_conv5", "conv5_3", ""))
INT8_OPS_PER_S = 1979e12


def int8_product_check(net, frames, card):
    """The int8 product (im2col + ``torch._int_mm``) of the quantized
    flagship at the layers of INT8_LAYERS, fed the rgb expert's own int8
    inputs on one frame (the stems through the packed stem, as served):
    exact (int32) against its plain version; then, each after the 1 GiB
    L2 flush, the quantize pass, im2col, ``_int_mm``, and cuDNN's bf16
    conv of the same layer before and after them. Returns the records of
    the int8-product line."""
    import torch.nn.functional as F
    from modular_semantic_segmentation_torch.models.packed_experts import \
        packed_fcn_stems
    from modular_semantic_segmentation_torch.models.simple_fcn import fcn
    from modular_semantic_segmentation_torch.ops import int8_conv
    from modular_semantic_segmentation_torch.ops.variables import Ctx
    from modular_semantic_segmentation_torch.utils.profiling import cold_ms
    m = "rgb"
    batch = net._preprocess(net._batch_to_device(
        {k: frames[k][:1] for k in MODALITIES}))
    with torch.inference_mode():
        ctx = Ctx(net.variables, compute_dtype=torch.bfloat16,
                  kernel_cache=net._kernel_cache, act_scales=net.act_scales)
        stems = packed_fcn_stems(ctx, batch, list(MODALITIES),
                                 {k: k for k in MODALITIES})
        layers = fcn(ctx, batch[m], m, NUM_UNITS, NUM_CLASSES,
                     batchnorm=False, stem_layers=stems[m])
    records = []
    for name, source, prefix in INT8_LAYERS:
        key = f"{prefix}{m}/{name}/input_amax"
        check(key in net.act_scales, f"int8 product: {key} not quantized")
        x = layers[source]
        kernel = net.variables[f"{m}/{name}/kernel"]
        k, cout = kernel.shape[0], kernel.shape[-1]
        kq, _ = int8_conv.quantize_kernel(kernel)
        kq_t = kq.reshape(-1, cout).t().contiguous()
        ascale = torch.full((1,), net.act_scales[key], dtype=torch.float32,
                            device=kernel.device)
        pads = ((k // 2, k // 2), (k // 2, k // 2))
        geometry = ((k, k), (1, 1), (1, 1), pads)
        xq = int8_conv.quantize(x, ascale)
        patches, _ = int8_conv.im2col(xq, *geometry)
        got = int8_conv.int8_matmul(patches, kq_t)
        want = int8_conv.int8_matmul_plain(patches, kq_t)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"int8 product at {name} differs from its plain version by "
              f"{int((got.long() - want.long()).abs().max())}")
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = kernel.permute(3, 2, 0, 1).to(torch.bfloat16)

        def cudnn():
            F.conv2d(xb, wb, padding=k // 2)

        library = [cold_ms(cudnn)]
        quant = cold_ms(lambda: int8_conv.quantize(x, ascale))
        im2col = cold_ms(lambda: int8_conv.im2col(xq, *geometry))
        int_mm = cold_ms(lambda: int8_conv.int8_matmul(patches, kq_t))
        library.append(cold_ms(cudnn))
        plain = cold_ms(lambda: int8_conv.int8_matmul_plain(patches, kq_t))
        rows, depth = patches.shape
        n_bytes = xq.numel() + kq_t.numel() + 4 * rows * cout
        bound, bound_by = bound_ms(n_bytes, 2.0 * rows * depth * cout,
                                   INT8_OPS_PER_S)
        print(f"int8 product {name} [{', '.join(map(str, x.shape))}] -> "
              f"{cout} ({key}; m {rows}, k {depth}, n {cout}): exact vs "
              f"plain (int32); quantize {quant:.4f} ms, im2col "
              f"{im2col:.4f} ms, _int_mm {int_mm:.4f} ms, cuDNN bf16 conv "
              f"{_runs(library)} ms, plain (float64 product) {plain:.4f} "
              f"ms, bound of im2col + _int_mm {bound:.4f} ms ({bound_by}) "
              f"on {card}")
        records.append({"layer": name, "m": rows, "k": depth, "n": cout,
                        "quantize_ms": quant, "im2col_ms": im2col,
                        "int_mm_ms": int_mm,
                        "cudnn_bf16_ms": sum(library) / 2,
                        "plain_ms": plain, "bound_ms": bound,
                        "bound_by": bound_by})
    return records


def int8_serving(bayes, dirich, frames, serve_frames, card):
    """The int8 serving path of the flagship: calibration on the measure
    frames and ``quantize_for_serving`` (Bayes; Dirichlet takes the same
    scales as data), the int8 product checked and timed, Bayes and
    Dirichlet (kernel B) served in int8 in turns with bf16, ``score`` in
    int8 (kernel A), a traced int8 group, and ``dequantize_serving``
    giving back the bf16 labels bit for bit. Returns (the int8-product
    records, launches of A, B and ``_int_mm`` on the int8 path)."""
    from modular_semantic_segmentation_torch.ops import int8_conv
    from modular_semantic_segmentation_torch.ops.cuda import (
        confusion, dirichlet)
    start = time.perf_counter()
    scales = bayes.quantize_for_serving(frames, num_batches=MEASURE_FRAMES)
    calibrate_s = time.perf_counter() - start
    check(dirich.quantize_for_serving(scales) is scales,
          "Dirichlet did not take the flagship's scales")
    for m in MODALITIES:
        convs = sorted(k.split("/")[1] + ("*" if k.startswith("packed:")
                                          else "")
                       for k in scales if k.split("/")[0].endswith(m))
        print(f"int8 convs of the {m} expert ({len(convs)}; * = packed "
              f"key): {', '.join(convs)}")
        for conv in ("conv1_2", "conv2_1"):
            check(f"packed:{m}/{conv}/input_amax" in scales,
                  f"{m} {conv}: no packed int8 scale")
        check(not any(f"{m}/{conv}/input_amax" in scales
                      for conv in ("conv1_1", "conv1_2", "conv2_1")),
              f"{m}: a stem conv has an unpacked int8 scale")
    print(f"int8 calibration: {MEASURE_FRAMES} measure frames at "
          f"{HEIGHT}x{WIDTH}, bf16, {len(scales)} convs quantized "
          f"(min_channels 128, min_pixels {bayes.ptq_min_pixels}) in "
          f"{calibrate_s:.1f} s host clock on {card}")
    records = int8_product_check(bayes, frames, card)

    # ---- the int8 path: launch counts from 0
    for counter in (confusion.KERNEL, dirichlet.KERNEL, int8_conv.INT_MM):
        counter.launches = 0
    b_int8 = 0
    for name, net in (("Bayes", bayes), ("Dirichlet", dirich)):
        runs = {"bf16": [], "int8": []}
        labels = {}
        for mode in ("bf16", "int8", "int8", "bf16"):
            if mode == "bf16":
                net.dequantize_serving()
            else:
                net.quantize_for_serving(scales)
            before = dirichlet.KERNEL.launches
            labels[mode], ms = serve(net, serve_frames)
            if mode == "int8":
                b_int8 += dirichlet.KERNEL.launches - before
            runs[mode] += ms
            check_labels(labels[mode], f"{name} int8 serving ({mode})")
        agree = float((labels["int8"] == labels["bf16"]).mean())
        print(f"{name} serving, int8 against bf16 in turns (bf16, int8, "
              f"int8, bf16; three runs each after a warm-up, "
              f"{SERVE_FRAMES} frames at {HEIGHT}x{WIDTH}, unroll "
              f"{UNROLL}, host clock, synchronised): int8 "
              f"{_runs(runs['int8'])} ms/frame, bf16 {_runs(runs['bf16'])} "
              f"ms/frame; int8 and bf16 fused labels agree on "
              f"{100 * agree:.2f}% of pixels on {card}")
    check(b_int8 >= 2 * 4 * SERVE_FRAMES, f"int8 Dirichlet serving launched "
          f"kernel B {b_int8} times")
    bayes.quantize_for_serving(scales)
    measures, cm = bayes.score(frames)
    labelled = int(((frames["labels"] >= 0)
                    & (frames["labels"] < NUM_CLASSES)).sum())
    check(cm.sum() == labelled and np.isfinite(measures["mean_IoU"]),
          f"int8 score counted {cm.sum()} of {labelled} pixels")
    launches = {"confusion": confusion.KERNEL.launches,
                "dirichlet": dirichlet.KERNEL.launches,
                "int_mm": int8_conv.INT_MM.launches}
    # ---- end of the int8 path
    print(f"int8 score of {MEASURE_FRAMES} frames: mean_IoU "
          f"{measures['mean_IoU']:.4f}; int8 path launches: confusion "
          f"{launches['confusion']}, dirichlet {launches['dirichlet']} "
          f"({b_int8} in int8 serving), _int_mm {launches['int_mm']}")
    check(launches["confusion"] > 0, "int8 score launched no kernel A")
    check(launches["int_mm"] > 0, "the int8 path ran no _int_mm")
    serving_profile(bayes, serve_frames, "Bayes-int8")

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        quantized = forward(bayes, frames)["fused_score"]
        bayes.dequantize_serving()
        dirich.dequantize_serving()
        floated = forward(bayes, frames)
        bayes.quantize_for_serving(scales)
        forward(bayes, frames)
        bayes.dequantize_serving()
        again = forward(bayes, frames)
    finally:
        torch.backends.cudnn.deterministic = saved
    check(not torch.equal(quantized, floated["fused_score"]),
          "int8 and bf16 fused scores are equal: the int8 path did not run")
    check(all(torch.equal(again[k], floated[k]) for k in floated),
          "dequantize_serving does not give back the bf16 outputs")
    print("dequantize_serving: bf16 outputs after int8 serving equal the "
          "bf16 outputs before it, bit for bit (cuDNN deterministic)")
    return records, launches


TRAIN_FRAMES = 4
TRAIN_STEPS = 20
BAYES_TRAIN_STEPS = 3
VALIDATION_INTERVAL = 5
TRAIN_WARMUP = 2
TRAIN_BLOCK = 32
TRAIN_BORDER = 16
TRAIN_DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32},
    {"rgb": (None, None, 3), "labels": (None, None)}, NUM_CLASSES)


def learnable_frames(seed, count):
    """rgb frames whose labels are a function of the input that the FCN
    can learn: the red channel of 32x32 blocks (the encoder's coarsest
    cell) quantized to the classes, a little noise on every channel, and
    a void (-1) border of 16 pixels."""
    rng = np.random.RandomState(seed)
    blocks = rng.rand(count, HEIGHT // TRAIN_BLOCK, WIDTH // TRAIN_BLOCK, 3)
    rgb = (np.repeat(np.repeat(blocks, TRAIN_BLOCK, 1), TRAIN_BLOCK, 2)
           * 247 + rng.rand(count, HEIGHT, WIDTH, 3) * 8)
    labels = np.minimum((blocks[..., 0] * NUM_CLASSES).astype(np.int32),
                        NUM_CLASSES - 1)
    labels = np.repeat(np.repeat(labels, TRAIN_BLOCK, 1), TRAIN_BLOCK, 2)
    b = TRAIN_BORDER
    labels[:, :b] = labels[:, -b:] = -1
    labels[:, :, :b] = labels[:, :, -b:] = -1
    return {"rgb": rgb.astype(np.float32), "labels": labels.astype(np.int32)}


def score_checked(score, data, what, pending=None):
    """``score(data)`` with kernel A's counts held against its plain
    version on the same predictions; returns (measures, counts). The
    plain version runs after the score returns; with a list ``pending``
    its check is appended there to run later, outside whatever times the
    score."""
    from modular_semantic_segmentation_torch.ops import metrics
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    accumulate, batches = metrics.confusion_accumulate, []

    def recorded(predictions, labels, k, total):
        batches.append((predictions, labels, k))
        return accumulate(predictions, labels, k, total)

    metrics.confusion_accumulate = recorded
    try:
        measures, counts = score(data)
    finally:
        metrics.confusion_accumulate = accumulate

    def verify():
        with torch.inference_mode():
            want = sum(confusion.confusion_counts_plain(*batch)
                       for batch in batches).cpu().numpy().astype(np.float32)
        check(np.array_equal(counts, want), f"{what}: kernel A's confusion "
              "counts differ from its plain version")

    if pending is None:
        verify()
    else:
        pending.append(verify)
    return measures, counts


def train_run(net, frames, steps, validation=None):
    """``net.fit`` for ``steps`` steps, observed from outside: each train
    step on the host clock between two synchronisations and its loss;
    each validation ``score`` with its counts held against kernel A's
    plain version on the same predictions. Returns (ms per step, losses,
    peak bytes allocated, validations)."""
    step, score = net._train_step, net.score
    times, losses, validations = [], [], []

    def timed_step(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        losses.append(float(out[2]))
        return out

    def checked_score(data, *args, **kwargs):
        measures, counts = score_checked(
            lambda d: score(d, *args, **kwargs), data, "validation")
        validations.append(int(counts.sum()))
        return measures, counts

    net._train_step, net.score = timed_step, checked_score
    torch.cuda.reset_peak_memory_stats()
    try:
        net.fit(frames, steps, output=False, validation_dataset=validation,
                validation_interval=VALIDATION_INTERVAL)
    finally:
        del net._train_step, net.score
    return times, losses, torch.cuda.max_memory_allocated(), validations


def check_trained(net, before, losses, what, falls=True):
    """Gates of a training run: finite losses, falling ones, the frozen
    deconv kernels bit for bit, the BN moving statistics moved."""
    check(np.isfinite(losses).all(), f"{what}: non-finite loss {losses}")
    if falls:
        check(losses[-1] < losses[0], f"{what}: the loss did not fall "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    frozen = [k for k in before if k.endswith(("upscore_conv5/kernel",
                                               "upscore/kernel"))]
    check(len(frozen) == 2 and not any(net.trainable[k] for k in frozen),
          f"{what}: the deconv kernels are not frozen")
    for k in frozen:
        check(torch.equal(net.variables[k], before[k]),
              f"{what}: frozen {k} changed")
    moving = [k for k in before if k.endswith("moving_mean")]
    check(moving and all(not torch.equal(net.variables[k], before[k])
                         for k in moving),
          f"{what}: a BN moving mean did not move")


def train_profile(net, frames):
    """torch.profiler over one bf16 train step (a separate, traced step
    after the timed ones): device time by kernel, busy and idle share.
    The trace is written to traces/train_bf16/trace.json."""
    from torch.autograd import DeviceType
    from modular_semantic_segmentation_torch.utils.profiling import trace
    batch = net._batch_to_device({k: v[:1] for k, v in frames.items()})
    net._train_step(net.variables, net.opt_state, batch)
    torch.cuda.synchronize()
    with trace(os.path.join(TRACE_DIR, "train_bf16")) as prof:
        start = time.perf_counter()
        net._train_step(net.variables, net.opt_state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("bf16 train step profile: not measured (no device time "
              "recorded)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"bf16 train step profile, traced: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, idle share {1 - busy / wall:.2f}, "
          f"{launches} kernel launches; top kernels (ms, launches, name):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} x{e.count:4d}  "
              f"{e.key[:100]}")


def training(card):
    """The training path: the flagship's rgb expert (SimpleFCN, 768x384,
    14 classes, num_units 64, batch norm, adam, batch 1) fitted on 4
    learnable frames for TRAIN_STEPS steps in float32 and in bf16, each
    validated on 2 held-out frames every VALIDATION_INTERVAL steps
    (``score``, kernel A); then BayesianFCN with the float32 run's
    weights (dropout 0.5) for BAYES_TRAIN_STEPS steps. Returns kernel A's
    launches on this path."""
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    frames = learnable_frames(5, TRAIN_FRAMES)
    validation = learnable_frames(6, 2)
    config = dict(prefix="rgb", modality="rgb",
                  data_description=TRAIN_DESCRIPTION, num_units=NUM_UNITS,
                  batch_normalization=True, trainer="adam", batchsize=1)
    confusion.KERNEL.launches = 0
    trained = None
    for dtype in ("float32", "bfloat16"):
        net = get_model("simple_fcn")(compute_dtype=dtype, **config)
        before = {k: v.clone() for k, v in net.variables.items()}
        times, losses, peak, validations = train_run(net, frames,
                                                     TRAIN_STEPS, validation)
        check_trained(net, before, losses, f"{dtype} training")
        check(validations and all(n == validations[0] for n in validations),
              f"{dtype} training: validations counted {validations}")
        steady = times[TRAIN_WARMUP:]
        print(f"training {dtype}: {statistics.median(steady):.3f} ms per "
              f"train step (median of {len(steady)} after {TRAIN_WARMUP} "
              f"warm-up steps; min {min(steady):.3f}, max {max(steady):.3f};"
              f" host clock, synchronised) at {HEIGHT}x{WIDTH}, batch 1, "
              f"peak memory {peak / 2**30:.3f} GiB, {len(validations)} "
              f"validations of {validations[0]} labelled pixels on {card}")
        print(f"training {dtype} losses: "
              + " ".join(f"{x:.4f}" for x in losses))
        if dtype == "float32":
            trained = net
        else:
            train_profile(net, frames)
    bayes = get_model("bayesian_fcn")(dropout_rate=0.5, **config)
    bayes.variables = {k: v.clone() for k, v in trained.variables.items()}
    before = {k: v.clone() for k, v in bayes.variables.items()}
    times, losses, peak, _ = train_run(bayes, frames, BAYES_TRAIN_STEPS)
    check_trained(bayes, before, losses, "BayesianFCN training",
                  falls=False)
    print(f"training BayesianFCN float32, dropout 0.5: "
          f"{_runs(times)} ms per step (host clock, synchronised), peak "
          f"memory {peak / 2**30:.3f} GiB, losses "
          + " ".join(f"{x:.4f}" for x in losses))
    launches = confusion.KERNEL.launches
    check(launches > 0, "the training path launched no confusion kernel")
    print(f"training path: confusion launches {launches}")
    return launches


# phase 14, the other architectures: AdapNet experts served in the fusion
# family and trained; FusionFCN and ProgressiveFCN trained
ADAPNET_SERVE_FRAMES = 4
ADAPNET_TRAIN_STEPS = 10
OTHER_TRAIN_STEPS = 5
# the Dirichlet fit of the random AdapNet experts: their probabilities
# are near one-hot, and the EM runs to its 10,000-iteration cap on most
# classes (134 s on the host); its parameters only feed kernel B's check
ADAPNET_EM_ITERATIONS = 200
# the train-mode AdapNet step (64x96) on the card against the CPU: its
# loss, and each moving statistic's update over its largest |update| (at
# least 1e-3), forward quantities (``train_mode_step_check`` prints how
# far float32 lies from float64 in each)
TRAIN_MODE_LOSS_RTOL = 1e-5
MOVING_ATOL = 1e-3


def build_adapnets(device="cuda"):
    from modular_semantic_segmentation_torch.models import get_model
    return {m: get_model("adapnet")(
        data_description=DATA_DESCRIPTION, modality=m, num_units=NUM_UNITS,
        seed=10 + i, device=device) for i, m in enumerate(MODALITIES)}


def adapnet_serving(frames, card):
    """Two full-width AdapNet experts (rgb, depth; float32) score the
    measure frames (kernel A, its counts held against the plain version);
    Bayes on those matrices, Dirichlet (``use_pallas``, fitted on the
    frames, its EM bounded) and Average fusions of them serve ADAPNET_SERVE_FRAMES frames
    in bf16; kernel B's labels against its plain version on one frame;
    bf16 against float32 fused labels; a traced Bayes group."""
    from modular_semantic_segmentation_torch.ops import \
        dirichlet_estimation as de
    from modular_semantic_segmentation_torch.ops.cuda import dirichlet
    experts = build_adapnets()
    labelled = int(((frames["labels"] >= 0)
                    & (frames["labels"] < NUM_CLASSES)).sum())
    cms = {}
    for m, net in experts.items():
        start = time.perf_counter()
        measures, cms[m] = score_checked(net.score, frames,
                                         f"AdapNet {m} score")
        seconds = time.perf_counter() - start
        check(cms[m].sum() == labelled, f"AdapNet {m}: score counted "
              f"{cms[m].sum()} of {labelled} pixels")
        print(f"AdapNet {m} expert, score of {len(frames['labels'])} frames"
              f" at {HEIGHT}x{WIDTH} (float32): mean_IoU "
              f"{measures['mean_IoU']:.4f}, {seconds:.3f} s host clock, "
              f"kernel A's counts equal its plain version's on {card}")
    served = [{m: frames[m][i] for m in MODALITIES}
              for i in range(ADAPNET_SERVE_FRAMES)]
    kinds = {"Bayes": ("bayes_fusion", {"confusion_matrices": cms}),
             "Dirichlet": ("dirichlet_fusion", {"use_pallas": True}),
             "Average": ("average_fusion", {})}

    def fusion(name, dtype, **extra):
        kind, config = kinds[name]
        return fusion_model(kind, experts, expert_model="adapnet",
                            compute_dtype=dtype, **config, **extra)

    fusions = {name: fusion(name, "bfloat16") for name in kinds}
    solver = de.find_dirichlet_priors

    def bounded(*args, **kwargs):
        return solver(*args, **dict(kwargs, max_iter=ADAPNET_EM_ITERATIONS))

    de.find_dirichlet_priors = bounded
    try:
        params = fit_dirichlet(
            fusions["Dirichlet"], frames, card, what="AdapNet Dirichlet fit "
            f"(EM at most {ADAPNET_EM_ITERATIONS} iterations a class)")
    finally:
        de.find_dirichlet_priors = solver
    for name, net in fusions.items():
        before = dirichlet.KERNEL.launches
        out, ms = serve(net, served)
        check_labels(out, f"AdapNet {name} serving", ADAPNET_SERVE_FRAMES)
        launches = dirichlet.KERNEL.launches - before
        print(f"AdapNet {name} serving: {_runs(ms)} ms/frame over "
              f"{ADAPNET_SERVE_FRAMES} frames at {HEIGHT}x{WIDTH}, bf16, "
              f"unroll {UNROLL}, dirichlet launches {launches} (host clock,"
              f" synchronised; three runs after a warm-up) on {card}")
        check((launches > 0) == (name == "Dirichlet"), f"AdapNet {name} "
              f"serving launched kernel B {launches} times")
    dirich = fusions["Dirichlet"]
    one = {k: v[:1] for k, v in frames.items()}
    probs = [torch.from_numpy(dirich.predict(
        one, output_attr=f"{m}_norm_prob")).reshape(-1, NUM_CLASSES)
        for m in MODALITIES]
    coeffs, bias = dirich._kernel_tables(NUM_CLASSES)
    scores = dirichlet.dirichlet_scores_plain(torch.stack(probs), coeffs,
                                              bias)
    got = torch.from_numpy(dirich.predict(one).reshape(-1)).long()
    gap = scores.max(-1).values - scores.gather(1, got[:, None])[:, 0]
    rel = gap / scores.max(-1).values.abs().clamp_min(1e-30)
    b_differ = int((got != scores.argmax(-1)).sum())
    check(bool((rel <= TIE_RTOL).all()), "AdapNet Dirichlet: kernel B's "
          "labels are not ties of its plain version's scores")
    agree = []
    for name, net in fusions.items():
        extra = {"dirichlet_params": params} if name == "Dirichlet" else {}
        f32 = forward(fusion(name, "float32", **extra), one)["prediction"]
        same = f32 == forward(net, one)["prediction"]
        agree.append(f"{name} {float(same.float().mean()):.4f}")
    print(f"AdapNet Dirichlet: kernel B's labels on one served frame equal "
          f"its plain version's ({b_differ} differ, all ties within rel "
          f"{TIE_RTOL}); bf16 and f32 fused labels agree on a frame: "
          f"{', '.join(agree)} on {card}")
    serving_profile(fusions["Bayes"], served, "Bayes-AdapNet")
    return experts, cms


def with_depth(frames):
    """The learnable frames with a depth channel that carries the same
    signal: the red channel over 255."""
    return dict(frames, depth=frames["rgb"][..., :1] / 255.0)


def frames_loss(net, frames):
    """The mean train-mode loss of ``net`` over the frames, one frame at a
    time, without a gradient: the same frames before and after training,
    so that the frames' own spread does not enter."""
    from modular_semantic_segmentation_torch.ops.losses import one_hot
    from modular_semantic_segmentation_torch.ops.variables import Ctx
    losses = []
    with torch.no_grad():
        for i in range(len(frames["labels"])):
            batch = net._preprocess(net._batch_to_device(
                {k: v[i:i + 1] for k, v in frames.items()}))
            batch["labels"] = one_hot(batch["labels"], NUM_CLASSES)
            ctx = Ctx(net.variables, compute_dtype=net.compute_dtype,
                      train=True)
            losses.append(float(net._train_outputs(ctx, batch)["loss"]))
    return float(np.mean(losses))


def train_checked(what, net, frames, steps, validation, card):
    """``train_run``, gated: finite step losses, the loss over the
    training frames lower after than before, every validation counting
    the same pixels. Prints ms per step, peak memory and the losses."""
    before = frames_loss(net, frames)
    times, losses, peak, validations = train_run(net, frames, steps,
                                                 validation)
    after = frames_loss(net, frames)
    steady = times[TRAIN_WARMUP:]
    check(np.isfinite(losses).all(), f"{what}: non-finite loss {losses}")
    check(after < before, f"{what}: the loss over the training frames did "
          f"not fall ({before:.4f} -> {after:.4f})")
    check(validations and all(n == validations[0] for n in validations),
          f"{what}: validations counted {validations}")
    print(f"training {what}: {statistics.median(steady):.3f} ms per train "
          f"step (median of {len(steady)} after {TRAIN_WARMUP} warm-up "
          f"steps; min {min(steady):.3f}, max {max(steady):.3f}; host "
          f"clock, synchronised) at {HEIGHT}x{WIDTH}, batch 1, peak memory "
          f"{peak / 2**30:.3f} GiB, {len(validations)} validations of "
          f"{validations[0]} labelled pixels on {card}")
    print(f"training {what}: loss over the {len(frames['labels'])} "
          f"training frames {before:.4f} -> {after:.4f}; step losses "
          + " ".join(f"{x:.4f}" for x in losses))


def other_training(card):
    """AdapNet (rgb, adam 1e-4) for ADAPNET_TRAIN_STEPS steps in float32
    and in bf16, then FusionFCN (rmsprop 1e-4) and ProgressiveFCN (depth
    column, rgb lateral, adam 1e-4) for OTHER_TRAIN_STEPS bf16 steps, on
    the learnable frames, each validated through kernel A. Gates
    (``train_checked``): the loss over the training frames falls; AdapNet's
    upconv kernels and every BN moving statistic
    change; FusionFCN's bilinear deconvs and ProgressiveFCN's lateral
    column stay bit for bit, its adapter scales move."""
    from modular_semantic_segmentation_torch.models import get_model
    frames = with_depth(learnable_frames(5, TRAIN_FRAMES))
    validation = with_depth(learnable_frames(6, 2))
    common = dict(num_units=NUM_UNITS, batchsize=1)
    for dtype in ("float32", "bfloat16"):
        net = get_model("adapnet")(data_description=TRAIN_DESCRIPTION,
                                   modality="rgb", trainer="adam",
                                   compute_dtype=dtype, **common)
        before = {k: v.clone() for k, v in net.variables.items()}
        train_checked(f"AdapNet {dtype}", net, frames, ADAPNET_TRAIN_STEPS,
                      validation, card)
        for k in before:
            if k.endswith(("upconv/kernel", "moving_mean",
                           "moving_variance")):
                check(not torch.equal(net.variables[k], before[k]),
                      f"AdapNet {dtype}: {k} did not change")
    models = (
        ("FusionFCN", "fusion_fcn", {"prefixes": {m: m for m in MODALITIES}},
         lambda k: k.endswith("upscore_conv5/kernel")
         or k == "fused/upscore/kernel", None),
        ("ProgressiveFCN", "progressive_fcn",
         {"prefix": "depth", "modality": "depth",
          "lateral_columns": {"rgb": "rgb"}},
         lambda k: k.startswith("rgb_") or k.endswith("upscore/kernel")
         or k.endswith("upscore_conv5/kernel"), "/adapter/scale"))
    for what, name, config, frozen, moves in models:
        # no batch norm in these two: the rgb frames scaled to [0, 1]
        net = get_model(name)(data_description=DATA_DESCRIPTION,
                              compute_dtype="bfloat16",
                              input_scaling={"rgb": 1.0 / 255}, **common,
                              **config)
        before = {k: v.clone() for k, v in net.variables.items()}
        trainer = net.config.get("trainer", "adam")
        train_checked(f"{what} bfloat16 ({trainer})", net, frames,
                      OTHER_TRAIN_STEPS, validation, card)
        kept = [k for k in before if frozen(k)]
        check(kept and all(torch.equal(net.variables[k], before[k])
                           for k in kept),
              f"{what}: a frozen variable changed")
        moved = [k for k in before if moves and k.endswith(moves)]
        check(all(not torch.equal(net.variables[k], before[k])
                  for k in moved), f"{what}: an adapter scale did not move")
        print(f"{what}: {len(kept)} frozen variables bit for bit"
              + (f", {len(moved)} adapter scales moved" if moved else ""))


def adapnet_reference_checks(experts, cms):
    """AdapNet on the card against the CPU, 64x96: a float32 Bayes-AdapNet
    forward; one float32 SGD(1.0) step of the rgb expert with batch norm
    from random moving statistics (the two-limit gate of
    ``train_step_check``; the stem pool's routes recorded); and the
    train-mode step (``train_mode_step_check``)."""
    rng = np.random.RandomState(7)
    small = {"rgb": (rng.rand(1, 64, 96, 3) * 255).astype(np.float32),
             "depth": rng.rand(1, 64, 96, 1).astype(np.float32),
             "labels": rng.randint(-1, NUM_CLASSES,
                                   (1, 64, 96)).astype(np.int32)}
    cpu_experts = build_adapnets(device="cpu")
    bayes = {d: fusion_model("bayes_fusion", e, device=d,
                             expert_model="adapnet", confusion_matrices=cms)
             for d, e in (("cuda", experts), ("cpu", cpu_experts))}
    worst, same = 0.0, True
    for m in MODALITIES:
        got, want = (bayes[d].predict(small, output_attr=f"{m}_prob")
                     for d in ("cuda", "cpu"))
        worst = max(worst, float(np.abs(got - want).max()))
        got, want = (bayes[d].predict(
            small, output_attr=f"{m}_classification") for d in ("cuda",
                                                                "cpu"))
        same = same & (got == want)
    check(worst <= 1e-4, f"Bayes-AdapNet float32 experts on the card differ"
          f" from the CPU by {worst} in prob")
    got, want = (bayes[d].predict(small) for d in ("cuda", "cpu"))
    check(np.array_equal(got[same], want[same]), "Bayes-AdapNet labels on "
          "the card differ from the CPU's where the experts agree")

    card_net, cpu_net = experts["rgb"], cpu_experts["rgb"]
    for k, v in cpu_net.variables.items():
        if k.endswith("moving_mean"):
            v = torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * .1)
        elif k.endswith("moving_variance"):
            v = torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + .5)
        cpu_net.variables[k] = v
        card_net.variables[k] = v.cuda()
    fixed = train_step_check(card_net, cpu_net, small, train=False,
                             before_pool=adapnet_before_pool)
    train_mode = train_mode_step_check(card_net, cpu_net, small)
    print(f"AdapNet reference checks (64x96, CPU plain versions): "
          f"Bayes-AdapNet float32 expert prob max diff {worst:.3g}, labels "
          f"equal where the experts agree ({int(same.sum())} of {same.size}"
          f" pixels); batch norm from random moving statistics, {fixed}; "
          f"{train_mode}")


def moving_error(got, want):
    """The largest difference of one step's moving-statistic updates from
    a reference step's, over the reference's largest |update| (at least
    1e-3): (worst, its tensor)."""
    errors = {k: float((got[3][k] - ref).abs().max())
              / max(float(ref.abs().max()), 1e-3)
              for k, ref in want[3].items()}
    name = max(errors, key=errors.get)
    return errors[name], name


def train_mode_step_check(card_net, cpu_net, batch):
    """One float32 SGD(1.0) train step with batch norm in train mode on
    the card, held against the CPU's by its forward quantities: the loss
    within TRAIN_MODE_LOSS_RTOL and each moving statistic's update within
    MOVING_ATOL of its scale. A TF32 control step must fail both. The
    trainable deltas' distances from float64 on the card are printed,
    not gated: at random initialization they part from float64 by
    percents in float32 (PERF.md). Returns the summary."""
    from modular_semantic_segmentation_torch.ops.layers import \
        configure_float32
    cpu32, card32 = sgd_step(cpu_net, batch), sgd_step(card_net, batch)
    card64 = sgd_step(card_net, batch, torch.float64)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = sgd_step(card_net, batch)
    finally:
        configure_float32()
    loss_rel, tf_loss_rel = (abs(x[0] - cpu32[0]) / abs(cpu32[0])
                             for x in (card32, tf32))
    worst, name = moving_error(card32, cpu32)
    tf_worst, tf_name = moving_error(tf32, cpu32)
    f64_loss_rel = abs(card32[0] - card64[0]) / abs(card64[0])
    f64_worst, f64_name = moving_error(card32, card64)
    check(loss_rel <= TRAIN_MODE_LOSS_RTOL and np.isfinite(card32[0]),
          f"train-mode step: loss on the card {card32[0]}, on the CPU "
          f"{cpu32[0]}")
    check(worst <= MOVING_ATOL, f"train-mode step: {name}'s update on the "
          f"card differs from the CPU's by {worst} of its scale")
    check(tf_loss_rel > TRAIN_MODE_LOSS_RTOL and tf_worst > MOVING_ATOL,
          f"train-mode step: the TF32 control passes a limit (loss "
          f"{tf_loss_rel}, {tf_name} {tf_worst})")
    return (f"train-mode BN step against the CPU: loss relative difference"
            f" {loss_rel:.3g} (limit {TRAIN_MODE_LOSS_RTOL:g}), largest "
            f"moving-statistic update difference {worst:.3g} of its scale "
            f"({name}; limit {MOVING_ATOL:g}); TF32 control {tf_loss_rel:.3g}"
            f" and {tf_worst:.3g} ({tf_name}): fails both, as it must; "
            f"float32 against float64 on the card {f64_loss_rel:.3g} and "
            f"{f64_worst:.3g} ({f64_name}); L2 "
            f"distance of all trainable deltas from float64 on the card "
            f"{delta_l2(card32, card64):.3g} (card), "
            f"{delta_l2(cpu32, card64):.3g} (CPU), card against CPU "
            f"{delta_l2(card32, cpu32):.3g} (not gated)")


def adapnet_step_conditioning(card):
    """One SGD(1.0) train step (batch norm in train mode) of the rgb
    AdapNet at 768x384 on a learnable frame, in float32 and in float64 on
    the card: how far float32 lies from float64 at full size (printed,
    not gated)."""
    from modular_semantic_segmentation_torch.models import get_model
    net = get_model("adapnet")(data_description=TRAIN_DESCRIPTION,
                               modality="rgb", num_units=NUM_UNITS)
    frame = learnable_frames(5, 1)
    f32, f64 = sgd_step(net, frame), sgd_step(net, frame, torch.float64)
    worst, name, _, _, routes = step_errors(f32, f64, adapnet_before_pool)
    print(f"AdapNet train-mode SGD(1.0) step at {HEIGHT}x{WIDTH}, float32 "
          f"against float64 on the card: L2 distance of all deltas "
          f"{delta_l2(f32, f64):.3g}, largest delta difference {worst:.3g} "
          f"of its tensor's scale ({name}; stem pool windows routed "
          f"differently {routes}), loss {f32[0]:.6f} / {f64[0]:.6f} on "
          f"{card}")


def check_labels(out, what, count=SERVE_FRAMES, num_classes=NUM_CLASSES):
    check(out.shape == (count, HEIGHT, WIDTH),
          f"{what}: output shape {out.shape}")
    check(out.dtype == np.int32, f"{what}: labels of type {out.dtype}, the "
          "reference's are int32")
    check(out.min() >= 0 and out.max() < num_classes,
          f"{what}: labels outside [0, {num_classes})")


def reference_checks(experts, bayes, dirich):
    """The CUDA path against the plain versions on the CPU, 64x96."""
    from modular_semantic_segmentation_torch.ops import fusion_math as fm
    from modular_semantic_segmentation_torch.ops.cuda import dirichlet
    rng = np.random.RandomState(3)
    small = {"rgb": (rng.rand(1, 64, 96, 3) * 255).astype(np.float32),
             "depth": rng.rand(1, 64, 96, 1).astype(np.float32),
             "labels": rng.randint(-1, NUM_CLASSES + 1,
                                   (1, 64, 96)).astype(np.int32)}
    cpu_experts = build_experts(device="cpu")
    worst = 0.0
    for m in MODALITIES:
        got = experts[m].predict(small, output_attr="prob")
        want = cpu_experts[m].predict(small, output_attr="prob")
        check(np.isfinite(got).all(), f"{m} expert: non-finite probs")
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= 1e-4, f"float32 experts on the card differ from the CPU "
          f"by {worst} in prob")
    classes = [torch.from_numpy(bayes.predict(
        small, output_attr=f"{m}_classification")) for m in MODALITIES]
    want = torch.argmax(fm.bayes_fusion(
        classes, [bayes.confusion_matrices[m] for m in MODALITIES],
        bayes.config["class_prior"])[0], 3).numpy()
    check(np.array_equal(bayes.predict(small), want),
          "Bayes fusion on the card differs from the CPU fusion of the same "
          "expert classifications")
    probs = [torch.from_numpy(dirich.predict(
        small, output_attr=f"{m}_norm_prob")).reshape(-1, NUM_CLASSES)
        for m in MODALITIES]
    coeffs, bias = dirich._kernel_tables(NUM_CLASSES)
    scores = dirichlet.dirichlet_scores_plain(torch.stack(probs), coeffs,
                                              bias)
    got = torch.from_numpy(dirich.predict(small).reshape(-1)).long()
    gap = scores.max(-1).values - scores.gather(1, got[:, None])[:, 0]
    rel = gap / scores.max(-1).values.abs().clamp_min(1e-30)
    check(bool((rel <= TIE_RTOL).all()), "Dirichlet fusion on the card "
          "picks labels that are not ties of the CPU scores")
    stats = dirich._stats_step(dirich._batch_to_device(small))
    labels = torch.from_numpy(small["labels"])
    for m in MODALITIES:
        probs = torch.from_numpy(experts[m].predict(small, output_attr="prob"))
        ss, counts = fm.dirichlet_sufficient_statistics(probs, labels,
                                                        NUM_CLASSES)
        check(np.allclose(stats[m].cpu().numpy(), ss.numpy(), rtol=1e-4,
                          atol=0), f"{m}: Dirichlet sufficient statistics on "
              "the card differ from the CPU's")
        check(torch.equal(stats["class_counts"].cpu(), counts),
              "Dirichlet class counts on the card differ from the CPU's")
    step_summary = train_step_check(experts["rgb"], cpu_experts["rgb"],
                                    small)
    print(f"reference checks (64x96, CPU plain versions): expert prob max "
          f"diff {worst:.3g}; Bayes labels equal; Dirichlet labels equal "
          f"up to ties; Dirichlet sufficient statistics within rtol 1e-4; "
          f"{step_summary}")


def fixed_bn_step(net, variables, batch):
    """An SGD(1.0) step of ``net`` on ``batch`` with batch norm from its
    moving statistics (an affine map, as in eval mode): (new variables,
    loss). The same layers and loss as the train step."""
    from modular_semantic_segmentation_torch.ops.losses import one_hot
    from modular_semantic_segmentation_torch.ops.variables import (
        Ctx, split_trainable)
    device_batch = net._preprocess(net._batch_to_device(batch))
    device_batch["labels"] = one_hot(device_batch["labels"], NUM_CLASSES)
    train, frozen = split_trainable(variables, net.trainable)
    leaves = {k: v.detach().requires_grad_() for k, v in train.items()}
    ctx = Ctx({**frozen, **leaves}, compute_dtype=net.compute_dtype)
    with torch.enable_grad():
        loss = net._train_outputs(ctx, device_batch)["loss"]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return ({**variables, **{k: v - g for (k, v), g in zip(train.items(),
                                                             grads)}},
            loss.detach())


def sgd_step(net, batch, dtype=torch.float32, train=True):
    """One SGD(1.0) train step of ``net`` on ``batch``, its variables and
    convs in ``dtype``: (loss, {trainable name: delta, float64 on the
    host}, [argmax indices of each max pool, on the host], {moving
    statistic: its update, float64 on the host}). With SGD(1.0) a delta
    is the negative gradient. With ``train`` False, batch norm runs from
    its moving statistics (``fixed_bn_step``), which then stay."""
    import torch.nn.functional as F
    from modular_semantic_segmentation_torch.ops import layers as ll
    from modular_semantic_segmentation_torch.ops import optimizers
    routes, max_pool2d = [], ll.max_pool2d

    def recorded(ctx, x, pool_size, strides):
        out, idx = F.max_pool2d(x.permute(0, 3, 1, 2), pool_size, strides,
                                return_indices=True)
        routes.append(idx.cpu())
        return out.permute(0, 2, 3, 1)

    net._optimizer = optimizers.SGD(1.0)
    variables = {k: v.to(dtype) for k, v in net.variables.items()}
    compute_dtype = net.compute_dtype
    net.compute_dtype, ll.max_pool2d = dtype, recorded
    try:
        if train:
            new, _, loss = net._train_step(variables, {}, batch)
        else:
            new, loss = fixed_bn_step(net, variables, batch)
    finally:
        net.compute_dtype, ll.max_pool2d = compute_dtype, max_pool2d
    deltas = {k: (new[k] - variables[k]).double().cpu() for k in new}
    moving = ("moving_mean", "moving_variance")
    return (float(loss), {k: d for k, d in deltas.items()
                          if net.trainable[k]}, routes,
            {k: d for k, d in deltas.items() if k.endswith(moving)})


def delta_l2(got, want):
    """The L2 distance of all of one step's deltas from a reference
    step's, over the L2 norm of the reference's."""
    num = sum(float((got[1][k] - ref).pow(2).sum())
              for k, ref in want[1].items())
    return (num / sum(float(ref.pow(2).sum()) for ref in want[1].values())
            ) ** 0.5


def fcn_before_pool(name, pool):
    """Whether SimpleFCN's tensor ``name`` lies before its ``pool``-th max
    pool (1-based)."""
    block = re.search(r"/conv(\d)_", name)
    return block is not None and int(block.group(1)) <= pool


def adapnet_before_pool(name, pool):
    """Whether AdapNet's tensor ``name`` lies before its stem pool, its
    only one."""
    return pool >= 1 and "/block_0_" in name


def step_errors(got, want, before_pool=fcn_before_pool):
    """How far one step's deltas are from a reference step's, each
    tensor's largest difference over the reference's largest |delta| (at
    least 1e-3): (worst, its tensor, worst over the tensors no max pool
    that routes differently can reach, its tensor, windows routed
    differently by each pool).

    A pool window whose two largest inputs are within rounding of each
    other may send its gradient to another input in one step than in the
    other: the pool's output, and so every layer after it, is the same,
    but the convs before it take another gradient, in one output channel
    of the conv under the pool a difference of about one position's share
    of the reduction. That is a different route, not an arithmetic
    error; the tensors after the deepest such pool show the arithmetic
    alone."""
    rerouted = [int((a != b).sum()) for a, b in zip(got[2], want[2])]
    deepest = max((i + 1 for i, n in enumerate(rerouted) if n), default=0)
    errors = {k: float((got[1][k] - ref).abs().max())
              / max(float(ref.abs().max()), 1e-3)
              for k, ref in want[1].items()}
    name = max(errors, key=errors.get)
    clean = [k for k in errors if not before_pool(k, deepest)]
    check(clean, "train step: every tensor is before a rerouted pool")
    clean_name = max(clean, key=errors.get)
    return errors[name], name, errors[clean_name], clean_name, rerouted


def channel_share(got, want, name):
    """The share of the squared difference of kernel ``name``'s delta that
    lies in its one most-different output channel."""
    diff = (got[1][name] - want[1][name]).reshape(
        -1, want[1][name].shape[-1]).pow(2).sum(0)
    return float(diff.max() / diff.sum().clamp_min(1e-300))


def train_step_check(card_net, cpu_net, batch, train=True,
                     before_pool=fcn_before_pool):
    """One float32 SGD(1.0) train step (``sgd_step``, ``train``) of a model
    on the card, held against the same step on the CPU (loss within rtol
    STEP_LOSS_RTOL, each tensor's delta within STEP_ATOL of its scale) and
    against the step in float64 on the card (the same, and within
    ARITHMETIC_ATOL on the tensors no rerouted pool reaches). A control
    step with TF32 on must fail the float64 check, so the check sees a
    TF32-class backward. Returns the summary."""
    from modular_semantic_segmentation_torch.ops.layers import \
        configure_float32
    cpu32 = sgd_step(cpu_net, batch, train=train)
    card32 = sgd_step(card_net, batch, train=train)
    card64 = sgd_step(card_net, batch, torch.float64, train=train)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = sgd_step(card_net, batch, train=train)
    finally:
        configure_float32()
    loss_rel = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    check(loss_rel <= STEP_LOSS_RTOL, f"train step: loss on the card "
          f"{card32[0]}, on the CPU {cpu32[0]}")
    cpu_worst, cpu_name, _, _, cpu_routes = step_errors(card32, cpu32,
                                                        before_pool)
    check(cpu_worst <= STEP_ATOL, f"train step: {cpu_name}'s delta on the "
          f"card differs from the CPU's by {cpu_worst} of its scale")
    worst, name, clean, clean_name, routes = step_errors(card32, card64,
                                                         before_pool)
    check(worst <= STEP_ATOL and clean <= ARITHMETIC_ATOL,
          f"train step: float32 on the card against float64: {name} "
          f"{worst}, {clean_name} {clean} of its scale (rerouted pool "
          f"windows {routes})")
    tf_worst, tf_name, tf_clean, tf_clean_name, tf_routes = step_errors(
        tf32, card64, before_pool)
    check(tf_worst > STEP_ATOL and tf_clean > ARITHMETIC_ATOL,
          f"train step: the TF32 control passes the float64 check ({tf_name}"
          f" {tf_worst}, {tf_clean_name} {tf_clean})")
    share = (f", {channel_share(card32, card64, name):.3f} of it in one "
             f"output channel" if card64[1][name].ndim == 4 else "")
    return (f"float32 SGD(1.0) train step: loss relative difference "
            f"{loss_rel:.3g} (limit {STEP_LOSS_RTOL:g}); largest delta "
            f"difference against the CPU {cpu_worst:.3g} of its tensor's "
            f"scale ({cpu_name}; limit {STEP_ATOL:g}; pool windows routed "
            f"differently {cpu_routes}); against float64 on the card "
            f"{worst:.3g} ({name}{share}; pool windows routed differently "
            f"{routes}), {clean:.3g} after the rerouted pools ({clean_name};"
            f" limit {ARITHMETIC_ATOL:g}); TF32 control against float64 "
            f"{tf_worst:.3g} ({tf_name}), {tf_clean:.3g} after its rerouted "
            f"pools ({tf_clean_name}; pool windows routed differently "
            f"{tf_routes}): fails, as it must")


# phase 16, the experiment pipeline: the CLIs in-process, the flagship's
# expert width on the complementary synthetic dataset (5 classes)
PIPELINE_STEPS = 20
PIPELINE_SERVE_FRAMES = 4
# ``num_classes`` given: the dataset's class description says 4 without
# it, whatever ``complementary`` makes
PIPELINE_DATA = {"dataset": "unittest", "complementary": True,
                 "num_classes": 5, "height": HEIGHT, "width": WIDTH,
                 "num_train": 4, "num_measure": 4, "num_test": 8}
PIPELINE_NET = {"num_units": NUM_UNITS, "batch_normalization": True,
                "trainer": "adam", "learning_rate": 1e-3, "batchsize": 2,
                "seed": 1}
# the Dirichlet run's EM on the host, bounded as phase 14's: unbounded it
# took 19.1 and 39.4 s of the phase's 54 and 71 s on these experts (an
# H100 machine's host), and its parameters only feed kernel B and the
# record checks
PIPELINE_EM_ITERATIONS = ADAPNET_EM_ITERATIONS


class KernelChecks:
    """Each launch of kernels A and B on the pipeline held against its
    plain version on the same inputs: every ``score`` through
    ``score_checked`` (A's counts equal, checked when the block ends, so
    that no timed score pays for its check), and every Dirichlet label of
    B a tie, within TIE_RTOL, of its plain version's best score."""

    def __init__(self):
        self.scores, self.labels = 0, 0
        self.pending = []

    def __enter__(self):
        from modular_semantic_segmentation_torch.models.estimator import \
            Estimator
        from modular_semantic_segmentation_torch.ops.cuda import dirichlet
        self._score, self._label = Estimator.score, dirichlet.dirichlet_label
        real_score, real_label = self._score, self._label

        def score(net, data, *args, **kwargs):
            self.scores += 1
            return score_checked(lambda d: real_score(net, d, *args,
                                                      **kwargs),
                                 data, f"{type(net).__name__} score",
                                 self.pending)

        def label(probs, coeffs, bias):
            got = real_label(probs, coeffs, bias)
            scores = dirichlet.dirichlet_scores_plain(
                torch.stack([p.float() for p in probs]), coeffs.to(got.device),
                bias.to(got.device))
            gap = tie_gaps(scores, got, scores.argmax(-1))
            check(bool((gap <= TIE_RTOL).all()), "kernel B's labels are not "
                  "ties of its plain version's scores")
            self.labels += int(got.numel())
            return got

        Estimator.score, dirichlet.dirichlet_label = score, label
        return self

    def __exit__(self, *exc):
        from modular_semantic_segmentation_torch.models.estimator import \
            Estimator
        from modular_semantic_segmentation_torch.ops.cuda import dirichlet
        Estimator.score, dirichlet.dirichlet_label = self._score, self._label
        if exc[0] is None:
            for verify in self.pending:
                verify()


def run_cli(module, command, config, what, seconds):
    """One CLI run in-process through the port's shim; returns its run
    id, with its seconds on the host clock in ``seconds``."""
    start = time.perf_counter()
    module.ex.run(command, config_updates=config)
    torch.cuda.synchronize()
    seconds[what] = time.perf_counter() - start
    return module.ex.current_run._id


def check_records(store, runs):
    """Every run's record reads back through ExperimentData as COMPLETED,
    and so does the zip that ``dump`` writes of it (as ``<id>000.zip``,
    its weights or Dirichlet parameters equal)."""
    from modular_semantic_segmentation_torch.models.dirichlet_fusion import \
        load_measurements
    from modular_semantic_segmentation_torch.utils.experiment import \
        ExperimentData
    for what, run_id in runs.items():
        record = ExperimentData(run_id).get_record()
        check(record["status"] == "COMPLETED", f"{what} (run {run_id}): "
              f"status {record['status']}")
        zipped = ExperimentData(run_id).dump(
            os.path.join(store, "experiments", f"{run_id}000"))
        copy = ExperimentData(f"{run_id}000")
        check(copy.get_record()["config"] == record["config"]
              and copy.get_record()["info"].keys() == record["info"].keys(),
              f"{what}: the zip {zipped} reads back another record")
        if "weights" in " ".join(copy.artifacts):
            with np.load(ExperimentData(run_id).get_weights()) as a, \
                    np.load(copy.get_weights()) as b:
                check(all(np.array_equal(a[k], b[k]) for k in a.files),
                      f"{what}: the zip's weights differ")
        if "counts.npz" in copy.artifacts:
            a, b = (load_measurements(run_id),
                    load_measurements(f"{run_id}000"))
            check(all(np.array_equal(a[k], b[k]) for k in a),
                  f"{what}: the zip's Dirichlet parameters differ")


def pipeline_serving(runs, infos, card):
    """BayesFusion from the evaluation runs' records and DirichletFusion
    from the Dirichlet run's record serve PIPELINE_SERVE_FRAMES frames in
    bf16, each against a model built from the same arrays by hand."""
    from modular_semantic_segmentation_torch.datasets import get_dataset
    from modular_semantic_segmentation_torch.experiments.evaluation import \
        import_weights_into_network
    from modular_semantic_segmentation_torch.models import get_model
    data = get_dataset("unittest")(**{k: v for k, v in PIPELINE_DATA.items()
                                      if k != "dataset"})
    frames = [{m: blob[m] for m in MODALITIES}
              for blob in list(data.get_testset())[:PIPELINE_SERVE_FRAMES]]
    weights = {m: runs[f"training {m}"] for m in MODALITIES}
    description = data.get_data_description(num_classes=data.num_classes)
    common = {"num_units": NUM_UNITS, "batch_normalization": True,
              "expert_model": "fcn", "prefixes": {m: m for m in MODALITIES},
              "batchsize": 1, "compute_dtype": "bfloat16"}
    kinds = {
        "Bayes": ("bayes_fusion", {"eval_experiments": {
            m: runs[f"evaluation {m}"] for m in MODALITIES}}, {
            "confusion_matrices": {m: infos[f"evaluation {m}"][
                "confusion_matrix"] for m in MODALITIES}}),
        "Dirichlet": ("dirichlet_fusion", {
            "measurement_exp": runs["dirichlet_fusion"],
            "use_pallas": True}, {
            "dirichlet_params": infos["dirichlet_fusion"][
                "dirichlet_params"], "use_pallas": True})}
    out = {}
    for name, (kind, from_record, by_hand) in kinds.items():
        served = []
        for config in (from_record, by_hand):
            net = get_model(kind)(data_description=description, **common,
                                  **config)
            import_weights_into_network(net, weights, warnings=False)
            served.append(serve(net, frames))
        (labels, ms), (want, _) = served
        check_labels(labels, f"{name} from its record", PIPELINE_SERVE_FRAMES,
                     data.num_classes)
        check(np.array_equal(labels, want), f"{name} from its record serves "
              "other labels than the model built from the same arrays")
        out[name] = ms
        print(f"pipeline {name} serving, from its record: {_runs(ms)} "
              f"ms/frame over {PIPELINE_SERVE_FRAMES} frames at "
              f"{HEIGHT}x{WIDTH}, bf16, unroll {UNROLL}; labels equal the "
              f"model's built from the same arrays (host clock, "
              f"synchronised; three runs after a warm-up) on {card}")
    return out


def experiment_pipeline(card):
    """The paper's pipeline through the port's CLIs (phase 16): train the
    rgb and depth experts and record them, evaluate each run, fit and
    evaluate the Bayes and the Dirichlet (kernel B) fusion, then serve
    both fusions loaded from their records, in a temporary experiment
    store. Returns (launches of kernels A and B, checked scores)."""
    import tempfile
    from modular_semantic_segmentation_torch import settings
    from modular_semantic_segmentation_torch.experiments import (
        bayes_fusion, dirichlet_fusion, evaluation, training)
    from modular_semantic_segmentation_torch.ops.cuda import (
        confusion, dirichlet)
    from modular_semantic_segmentation_torch.models.dirichlet_fusion import \
        DirichletFusion
    net = dict(PIPELINE_NET)
    prefixes = {m: m for m in MODALITIES}
    saved = settings.EXPERIMENT_STORAGE_FOLDER, settings.EXP_OUT
    seconds, runs, infos = {}, {}, {}
    from modular_semantic_segmentation_torch.ops import \
        dirichlet_estimation as de
    em, em_seconds = DirichletFusion._fit_sufficient_statistic, [0.0]
    solver = de.find_dirichlet_priors

    def timed_em(*args):
        start = time.perf_counter()
        em(*args)
        em_seconds[0] += time.perf_counter() - start

    def bounded(*args, **kwargs):
        return solver(*args, **dict(kwargs, max_iter=PIPELINE_EM_ITERATIONS))

    DirichletFusion._fit_sufficient_statistic = timed_em
    de.find_dirichlet_priors = bounded
    with tempfile.TemporaryDirectory() as store, KernelChecks() as checks:
        settings.EXPERIMENT_STORAGE_FOLDER = os.path.join(store,
                                                          "experiments")
        settings.EXP_OUT = os.path.join(store, "exp")
        confusion.KERNEL.launches = dirichlet.KERNEL.launches = 0
        try:
            for m in MODALITIES:
                what = f"training {m}"
                runs[what] = run_cli(training, "main", {
                    "modelname": "simple_fcn", "device": "cuda",
                    "num_iterations": PIPELINE_STEPS, "seed": 1,
                    "starting_weights": False,
                    "dataset": {"name": "unittest", **{
                        k: v for k, v in PIPELINE_DATA.items()
                        if k != "dataset"}},
                    "net_config": dict(net, prefix=m, modality=m)},
                    what, seconds)
                infos[what] = training.ex.current_run.info
            for m in MODALITIES:
                what = f"evaluation {m}"
                runs[what] = run_cli(evaluation, "main", {
                    "modelname": "simple_fcn", "device": "cuda", "seed": 1,
                    "starting_weights": runs[f"training {m}"],
                    "evaluation_data": PIPELINE_DATA,
                    "net_config": dict(net, prefix=m, modality=m)},
                    what, seconds)
                infos[what] = evaluation.ex.current_run.info
            fusion_net = {"num_units": NUM_UNITS, "batch_normalization": True,
                          "expert_model": "fcn", "prefixes": prefixes,
                          "batchsize": 2}
            weights = {m: runs[f"training {m}"] for m in MODALITIES}
            for what, module, extra in (
                    ("bayes_fusion", bayes_fusion, {}),
                    ("dirichlet_fusion", dirichlet_fusion,
                     {"use_pallas": True})):
                runs[what] = run_cli(module, "main", {
                    "device": "cuda", "seed": 1,
                    "evaluation_data": PIPELINE_DATA,
                    "starting_weights": weights,
                    "net_config": dict(fusion_net, **extra)}, what, seconds)
                infos[what] = module.ex.current_run.info
            served = pipeline_serving(runs, infos, card)
            launches = {"confusion": confusion.KERNEL.launches,
                        "dirichlet": dirichlet.KERNEL.launches}
            check_records(store, runs)
        finally:
            settings.EXPERIMENT_STORAGE_FOLDER, settings.EXP_OUT = saved
            DirichletFusion._fit_sufficient_statistic = em
            de.find_dirichlet_priors = solver
    ious = {m: infos[f"evaluation {m}"]["measurements"] for m in MODALITIES}
    ious["Bayes"] = infos["bayes_fusion"]["measurements"]["fusion"]
    ious["Dirichlet"] = infos["dirichlet_fusion"]["measurements"]
    print("pipeline runs (seconds, host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; of the Dirichlet run, EM {em_seconds[0]:.2f} (at most "
        f"{PIPELINE_EM_ITERATIONS} iterations a class) on {card}")
    print("pipeline mean IoU (test set; Dirichlet on its test half): "
          + ", ".join(f"{k} {v['mean_IoU']:.4f}" for k, v in ious.items()))
    print(f"pipeline kernel checks: {checks.scores} scores with kernel A's "
          f"counts equal to its plain version's, {checks.labels} kernel B "
          f"labels ties of its plain version's; records and their zips read"
          f" back ({len(runs)} runs)")
    return launches, served


# phase 17, the training input pipeline: a raw SYNTHIA sequence written by
# the port's PNG writer, preprocessed and read by the port's driver, and
# the rgb expert trained on it at 640x368 full width, batch 4, as
# experiments/example_config.yaml sets it, with the on-device augmentation
# of experiments/timing.py:348-350 (its crop side the frame's height, so
# the square crop lies inside the frame)
INPUT_SEQUENCE = "SYNTHIA-SEQS-04-DAWN"
INPUT_FRAMES = 8
INPUT_RAW = (760, 1280)
INPUT_BLOCK = 64
INPUT_STEPS = 10
INPUT_BATCH = 4
INPUT_ASSEMBLY_BATCHES = 6
INPUT_AUGMENTATION = {"scale": (0.4, 0.7, 1.5), "hflip": 0.5,
                      "gamma": (0.4, 0.3, 1.2), "crop": (1.0, 368)}
INPUT_NET = {"num_units": NUM_UNITS, "batch_normalization": True,
             "trainer": "adam", "learning_rate": 1e-3,
             "batchsize": INPUT_BATCH}
# the general warp path (rotation and shear) against the separable one
INPUT_GENERAL = {"rotate": (1.0, -10, 10), "shear": (1.0, 0.05, 0.1),
                 "crop": (1.0, 368)}
INPUT_WARP_TIE = 1e-3


def write_synthia_sequence(base):
    """INPUT_FRAMES raw frames of 1280x760 in SYNTHIA's layout (RGB,
    Depth, GT/LABELS under Stereo_Right/Omni_F), written with the port's
    PNG writer: 14-class labels that are the red channel of 64x64 blocks
    quantized (32x32 after the 2x downsampling), in the crude format's
    first channel with decoys in the others; rgb those blocks with noise;
    16-bit depth in the first channel of a 16-bit colour file."""
    from modular_semantic_segmentation_torch.datasets import image_io
    rng = np.random.RandomState(17)
    h, w = INPUT_RAW
    root = os.path.join(base, INPUT_SEQUENCE)
    for i in range(INPUT_FRAMES):
        blocks = rng.rand(h // INPUT_BLOCK + 1, w // INPUT_BLOCK + 1, 3)
        big = np.repeat(np.repeat(blocks, INPUT_BLOCK, 0), INPUT_BLOCK,
                        1)[:h, :w]
        bgr = (big * 247 + rng.rand(h, w, 3) * 8).astype(np.uint8)
        labels = np.minimum((big[..., 2] * NUM_CLASSES).astype(np.uint8),
                            NUM_CLASSES - 1)
        crude = np.stack([labels, np.full_like(labels, 200),
                          np.full_like(labels, 100)], -1)
        depth = np.stack([rng.randint(0, 60000, (h, w))] * 3,
                         -1).astype(np.uint16)
        for sub, image in (("RGB", bgr), ("Depth", depth),
                           ("GT/LABELS", crude)):
            folder = os.path.join(root, sub, "Stereo_Right", "Omni_F")
            os.makedirs(folder, exist_ok=True)
            image_io.imwrite(os.path.join(folder, f"{i:06d}.png"), image)


def assembly_rate(data, workers):
    """Decode + assembly frames/s of the trainset's batches with a pool of
    ``workers`` (host clock, after one warm-up batch)."""
    batches = data.get_trainset().batches(INPUT_BATCH, shuffle=True,
                                          repeat=True, seed=0,
                                          workers=workers)
    next(batches)
    start = time.perf_counter()
    for _ in range(INPUT_ASSEMBLY_BATCHES):
        next(batches)
    seconds = time.perf_counter() - start
    batches.close()
    return INPUT_ASSEMBLY_BATCHES * INPUT_BATCH / seconds


def loader_wait(net, data, workers, prefetch):
    """``fit``'s loop by hand for INPUT_STEPS steps: the host clock of the
    wait for each batch (``next``) and of each synchronised train step.
    With ``prefetch`` the batches come from ``to_device_prefetched`` over
    a pool of ``workers``; without it they are assembled in the loop and
    copied inside the step, as before the loader. Returns the medians
    after TRAIN_WARMUP steps: (wait ms, step ms)."""
    from modular_semantic_segmentation_torch.utils.data_io import (
        to_device_prefetched, training_batches)
    batches = training_batches(data.get_trainset(), INPUT_BATCH, seed=0,
                               workers=workers)
    if prefetch:
        batches = to_device_prefetched(batches, "cuda")
    waits, steps = [], []
    variables, opt_state = net.variables, net.opt_state
    try:
        for _ in range(INPUT_STEPS):
            start = time.perf_counter()
            batch = next(batches)
            waits.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            variables, opt_state, _ = net._train_step(variables, opt_state,
                                                      batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - start) * 1e3)
    finally:
        batches.close()
    return (statistics.median(waits[TRAIN_WARMUP:]),
            statistics.median(steps[TRAIN_WARMUP:]))


def warp_card_against_cpu(batch):
    """``_warp`` on the card against the CPU for the same maps: the
    separable and the general path, order 0 (labels) exact, order 1 on
    uint8 rgb exact except rounding ties. Returns the ties' count."""
    from modular_semantic_segmentation_torch.ops import device_augment as da
    gen = torch.Generator(device="cuda").manual_seed(5)
    rgb = batch["rgb"].clamp(0, 255).round().to(torch.uint8)
    h, w = rgb.shape[1:3]
    ties = 0
    for config, aligned in ((INPUT_AUGMENTATION, True),
                            (INPUT_GENERAL, False)):
        geometry = {k: v for k, v in config.items() if k in (
            "scale", "crop", "hflip", "vflip", "rotate", "shear")}
        u = da.draw_uniforms(gen, rgb.shape[0], da.GEOMETRY_DRAWS)
        side = config["crop"][1]
        m = da.geometry_from_draws(u, h, w, side, side, **geometry)
        m_cpu = m.cpu()
        labels = da._warp(batch["labels"], m, side, side, 0, aligned)
        want = da._warp(batch["labels"].cpu(), m_cpu, side, side, 0,
                        aligned)
        check(torch.equal(labels.cpu(), want), "the card's nearest warp "
              f"differs from the CPU's (axis_aligned={aligned})")
        got = da._warp(rgb, m, side, side, 1, aligned).cpu().int()
        want = da._warp(rgb.cpu(), m_cpu, side, side, 1, aligned).int()
        exact = da._warp(rgb.cpu().float(), m_cpu, side, side, 1, aligned)
        tie = ((exact - exact.floor()) - 0.5).abs() < INPUT_WARP_TIE
        diff = (got - want).abs()
        check(int(diff.max()) <= 1 and not bool(diff[~tie].any()),
              f"the card's bilinear warp differs from the CPU's off ties "
              f"(axis_aligned={aligned})")
        ties += int((diff > 0).sum())
    return ties


def warp_path_ms(batch, config):
    """Device ms of ``augment_batch`` over a batch of INPUT_BATCH on the
    card (CUDA events, mean of 20 after 3 warm-ups, L2 flushed)."""
    from modular_semantic_segmentation_torch.ops import device_augment as da
    from modular_semantic_segmentation_torch.utils.profiling import cold_ms
    gen = torch.Generator(device="cuda").manual_seed(6)
    return cold_ms(lambda: da.augment_batch(gen, batch, **config))


def augmented_step_profile(net, batch):
    """torch.profiler over one augmented train step (after the timed fit):
    device busy and idle share, top kernels. The trace is written to
    traces/input_pipeline/trace.json."""
    from torch.autograd import DeviceType
    from modular_semantic_segmentation_torch.utils.profiling import trace
    net._train_step(net.variables, net.opt_state, batch)
    torch.cuda.synchronize()
    with trace(os.path.join(TRACE_DIR, "input_pipeline")) as prof:
        start = time.perf_counter()
        net._train_step(net.variables, net.opt_state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("augmented train step profile: not measured (no device time "
              "recorded)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"augmented train step profile, traced: device busy {busy:.3f} ms"
          f" of {wall:.3f} ms wall, idle share {1 - busy / wall:.2f}, "
          f"{sum(e.count for e in kernels)} kernel launches; top kernels "
          "(ms, launches, name):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} x{e.count:4d}  "
              f"{e.key[:100]}")


def prefetcher_reraises():
    """An exception injected into the prefetcher's producer reaches the
    consumer, after the batches before it."""
    from modular_semantic_segmentation_torch.utils.data_io import \
        to_device_prefetched

    class Injected(Exception):
        pass

    def producer():
        for i in range(3):
            yield {"x": np.full((2, 4), i, np.float32)}
        raise Injected("injected into the producer")

    seen = []
    try:
        for batch in to_device_prefetched(producer(), "cuda"):
            check(batch["x"].is_cuda, "a prefetched batch is not on the card")
            seen.append(float(batch["x"][0, 0]))
    except Injected:
        check(seen == [0.0, 1.0, 2.0], f"the prefetcher gave {seen} before "
              "the producer's exception")
        return
    raise SmokeFailure("the prefetcher ended without the producer's "
                       "exception")


def input_pipeline(card):
    """Phase 17: the training input pipeline (see INPUT_* above). Returns
    kernel A's launches on the phase's fits and scores."""
    import tempfile
    from modular_semantic_segmentation_torch.datasets import get_dataset
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.ops import device_augment as da
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    with tempfile.TemporaryDirectory() as base:
        start = time.perf_counter()
        write_synthia_sequence(base)
        written = time.perf_counter() - start
        start = time.perf_counter()
        data = get_dataset("synthia")(seqs=[INPUT_SEQUENCE], base_path=base)
        preprocessed = time.perf_counter() - start
        cores = os.cpu_count()
        rates = {w: assembly_rate(data, w) for w in (1, cores)}
        print(f"input pipeline: {INPUT_FRAMES} raw 1280x760 frames written "
              f"in {written:.2f} s; SYNTHIA preprocessing "
              f"{preprocessed / INPUT_FRAMES:.3f} s per frame; decode + "
              f"assembly of 640x368 batches of {INPUT_BATCH}: "
              f"{rates[1]:.1f} frames/s with 1 worker, "
              f"{rates[cores]:.1f} frames/s with {cores} (host clock) on "
              f"{card}")
        description = data.get_data_description()
        measure, test = data.get_measureset(), data.get_testset()
        per_score = -(-len(measure) // INPUT_BATCH)
        per_test = -(-len(test) // INPUT_BATCH)
        confusion.KERNEL.launches = 0
        expected = 0
        runs = {}
        for name, augmentation in (("augmented", INPUT_AUGMENTATION),
                                   ("plain", None)):
            config = dict(INPUT_NET, loader_workers=cores)
            if augmentation:
                config["device_augmentation"] = augmentation
            net = get_model("simple_fcn")(
                prefix="rgb", modality="rgb", data_description=description,
                **config)
            times, losses, peak, validations = train_run(
                net, data.get_trainset(), INPUT_STEPS, measure)
            check(np.isfinite(losses).all(),
                  f"{name} training: non-finite loss {losses}")
            measures, counts = score_checked(net.score, test, "test score")
            check(np.isfinite(measures["total_accuracy"]),
                  f"{name} training: non-finite test accuracy")
            expected += len(validations) * per_score + per_test
            steady = times[TRAIN_WARMUP:]
            print(f"input pipeline training, {name}: "
                  f"{statistics.median(steady):.3f} ms per train step "
                  f"(median of {len(steady)} after {TRAIN_WARMUP} warm-up "
                  f"steps; min {min(steady):.3f}, max {max(steady):.3f}; "
                  f"host clock, synchronised), batch {INPUT_BATCH} of "
                  f"{'368x368 crops' if augmentation else '368x640 frames'},"
                  f" {cores} loader workers, prefetched; peak memory "
                  f"{peak / 2**30:.3f} GiB; losses "
                  + " ".join(f"{x:.4f}" for x in losses)
                  + f"; test mean IoU {measures['mean_IoU']:.4f} on {card}")
            runs[name] = net
        launches = confusion.KERNEL.launches
        check(launches == expected, f"kernel A launched {launches} times on "
              f"the phase's fits and scores, expected {expected} "
              "(validation and score batches)")

        shares = []
        for workers, prefetch in ((cores, True), (1, True), (1, False)):
            wait, step = loader_wait(runs["augmented"], data, workers,
                                     prefetch)
            shares.append(f"{'prefetched, ' if prefetch else 'in the loop, '}"
                          f"{workers} worker{'s' if workers > 1 else ''}: "
                          f"wait {wait:.3f} ms, step {step:.3f} ms, host "
                          f"share {wait / (wait + step):.3f}")
        print("input pipeline, fit's loop by hand, augmented (medians, host "
              "clock, synchronised): " + "; ".join(shares) + f" on {card}")

        net = runs["augmented"]
        batch = next(data.get_trainset().batches(INPUT_BATCH, shuffle=True,
                                                 seed=3))
        batch = net._batch_to_device(batch)
        augmented = da.augment_batch(net._generator, batch,
                                     **INPUT_AUGMENTATION)
        labels = augmented["labels"]
        check(int(labels.min()) >= -1 and int(labels.max()) < NUM_CLASSES,
              "augmented labels outside [-1, K)")
        check(tuple(labels.shape) == (INPUT_BATCH, 368, 368),
              f"augmented labels of shape {tuple(labels.shape)}")
        augmented_step_profile(net, batch)
        ms = {name: warp_path_ms(batch, config) for name, config in (
            ("separable", INPUT_AUGMENTATION), ("general", INPUT_GENERAL))}
        print(f"device augmentation of a batch of {INPUT_BATCH} 368x640 "
              f"frames (rgb, depth, labels) to 368x368: separable path "
              f"{ms['separable']:.4f} ms, general path (rotate, shear) "
              f"{ms['general']:.4f} ms (CUDA events, L2 flushed) on {card}")
        ties = warp_card_against_cpu(batch)
        print(f"device augmentation card against CPU: nearest warps equal, "
              f"bilinear uint8 warps equal except {ties} rounding ties")
        prefetcher_reraises()
        print("prefetcher: the producer's injected exception reached the "
              "consumer")
    print(f"input pipeline path: confusion launches {launches} "
          f"(validation and score batches)")
    return launches


# phase 18, the experiment surface: the timing CLI at its defaults (768x384,
# num_units 64, 14 classes, bf16), its Table V report, int8 AdapNet, the
# uncertainty benchmarks on AddRandomObjects, finetuning, the progressive
# FCN and the IBCC dump, in-process in a temporary store
SURFACE_REPETITIONS = 10
SURFACE_OFFLINE = {"num_frames": 16, "batchsize": 8}
SURFACE_STEPS = 2
SURFACE_STEP_REPETITIONS = 3  # device_time_fn's runs of 8 and of 32 steps
SURFACE_CLASSES = 8  # the most UnittestData draws (its 8 class colours)
SURFACE_DATA = {"height": HEIGHT, "width": WIDTH, "num_train": 2,
                "num_measure": 2, "num_test": 2,
                "num_classes": SURFACE_CLASSES}
SURFACE_NET = {"num_units": NUM_UNITS, "batchsize": 1,
               "learning_rate": 1e-4}
SURFACE_BAYESIAN = {"prefix": "rgb", "modality": "rgb",
                    "num_units": NUM_UNITS, "batchsize": 1}
# the object library: textured ellipses, dark and bright, on black
SURFACE_OBJECTS = range(251, 259)
SURFACE_OBJECT_SIZE = (96, 128)


def write_object_library(base):
    """SURFACE_OBJECTS objects of SURFACE_OBJECT_SIZE in the Amsterdam
    Object Library's layout under ``base``, written with the port's PNG
    writer."""
    from modular_semantic_segmentation_torch.datasets import image_io
    rng = np.random.RandomState(5)
    h, w = SURFACE_OBJECT_SIZE
    rows, cols = np.mgrid[:h, :w]
    for num in SURFACE_OBJECTS:
        ry, rx = rng.randint(h // 4, h // 2), rng.randint(w // 4, w // 2)
        inside = ((rows - h / 2) / ry) ** 2 + ((cols - w / 2) / rx) ** 2 < 1
        low = 30 if num % 2 else 130
        obj = np.where(inside[..., None],
                       rng.randint(low, low + 100, (h, w, 3)), 0)
        folder = os.path.join(base, "amsterdam_object_lib", str(num))
        os.makedirs(folder)
        image_io.imwrite(os.path.join(folder, f"{num}_c.png"),
                         obj.astype(np.uint8))


def _timings(module, command, config):
    module.ex.run(command, config_updates=dict(config, device="cuda"))
    torch.cuda.synchronize()
    return module.ex.current_run._id, module.ex.current_run.info["timings"]


def surface_timing(card):
    """The timing CLI's rows: ``main`` at its defaults (Table V), AdapNet
    and Bayes-AdapNet in bf16 and int8, the serving group (Bayes bf16 and
    int8, Bayes-AdapNet int8), the train steps and the offline
    evaluation; then ``report timing_table`` of the ``main`` run. Returns
    the int8 AdapNet rows' ``_int_mm`` launches."""
    from modular_semantic_segmentation_torch.experiments import (
        report, timing)
    from modular_semantic_segmentation_torch.ops import int8_conv
    reps = {"repetitions": SURFACE_REPETITIONS}
    main_run, table_v = _timings(timing, "main", reps)
    check(set(table_v) == set(report.REFERENCE_TIMINGS_S), "timing main "
          f"recorded {list(table_v)}")
    rows = {}
    int_mm = {}
    for command, name in (("time_adapnet", "adapnet_rgb"),
                          ("time_bayes_adapnet", "bayes_adapnet")):
        for int8 in (False, True):
            before = int8_conv.INT_MM.launches
            _, got = _timings(timing, command, dict(reps, int8=int8))
            rows[name + ("_int8" if int8 else "")] = got[name]
            if int8:
                int_mm[name] = int8_conv.INT_MM.launches - before
    for model, int8 in (("bayes_fcn", False), ("bayes_fcn", True),
                        ("bayes_adapnet", True)):
        before = int8_conv.INT_MM.launches
        _, got = _timings(timing, "time_serving", dict(
            reps, model=model, int8=int8))
        rows.update(got)
        if int8 and model == "bayes_adapnet":
            int_mm["serving_bayes_adapnet"] = (int8_conv.INT_MM.launches
                                               - before)
    for model in ("simple_fcn", "adapnet"):
        _, got = _timings(timing, "time_train_step", dict(
            model=model, repetitions=SURFACE_STEP_REPETITIONS))
        rows.update(got)
    _, got = _timings(timing, "time_offline_eval", SURFACE_OFFLINE)
    rows.update(got)
    check(all(int_mm.values()), "an int8 AdapNet row launched no "
          f"_int_mm: {int_mm}")

    table = report.build_timing_table(main_run)
    print(f"Table V (timing main, bf16, {HEIGHT}x{WIDTH}, num_units "
          f"{NUM_UNITS}, 14 classes, repetitions {SURFACE_REPETITIONS}; "
          f"host clock, synchronised) on {card}, beside the paper's GTX "
          "1080 Ti figures (BASELINE.md):")
    print(table)
    for name in table.index:
        row = dict(zip(table.columns, table.values[table.index.index(name)]))
        print(f"Table V {name}: {row['s/frame'] * 1e3:.3f} ms/frame "
              f"pipelined, {row['sync s/frame'] * 1e3:.3f} +- "
              f"{row['±std'] * 1e3:.3f} ms sync; the paper's GTX 1080 Ti "
              f"{row['reference s/frame'] * 1e3:.1f} ms ({row['speedup']:.2f}"
              f"x) on {card}")
    for name, row in rows.items():
        if "s_per_step" in row:
            print(f"timing {name} ({row['model']}, batch "
                  f"{row['batchsize']}): {row['s_per_step'] * 1e3:.3f} ms "
                  f"per step (device_time_fn, the floors of "
                  f"{SURFACE_STEP_REPETITIONS} runs of 8 and of 32 steps) "
                  f"on {card}")
        elif "s_total" in row:
            print(f"timing {name}: {row['img_per_s']:.1f} frames/s, "
                  f"{row['num_frames']} frames at batch {row['batchsize']}"
                  f" ({row['s_total']:.3f} s, host clock) on {card}")
        else:
            per_frame = row.get("serving_s_per_frame",
                                row["pipelined_mean_s"])
            print(f"timing {name}: {per_frame * 1e3:.3f} ms/frame "
                  f"{'served (unroll 4)' if 'unroll' in row else 'pipelined'}"
                  f", {row['sync_mean_s'] * 1e3:.3f} ms sync on {card}")
    print(f"int8 AdapNet rows: _int_mm launches {int_mm}")
    return int_mm


def int8_adapnet_agreement(card):
    """Bayes-AdapNet as ``time_bayes_adapnet`` builds it, on a seeded
    frame: the labels in bf16, then calibrated on that frame and served in
    int8; the convs that went int8 and the share of labels that agree."""
    from modular_semantic_segmentation_torch.experiments import timing
    from modular_semantic_segmentation_torch.ops import int8_conv
    net = timing.BUILDERS["bayes_adapnet"][0](timing._cfg({}))
    frame = make_frames(3, 1)
    frame = {m: frame[m] for m in MODALITIES}
    bf16 = forward(net, frame)["prediction"]
    scales = net.quantize_for_serving(frame, num_batches=1)
    check(len(scales) > 0, "int8 Bayes-AdapNet quantized no conv")
    before = int8_conv.INT_MM.launches
    int8 = forward(net, frame)["prediction"]
    launches = int8_conv.INT_MM.launches - before
    check(launches > 0, "int8 Bayes-AdapNet launched no _int_mm")
    agree = float((bf16 == int8).float().mean())
    print(f"int8 Bayes-AdapNet: {len(scales)} convs int8 (floor "
          f"{net.ptq_min_pixels} input positions, at least 128 input "
          f"channels), {launches} _int_mm launches a frame; int8 and bf16 "
          f"labels agree on {agree:.4f} of a {HEIGHT}x{WIDTH} frame on "
          f"{card}")
    return len(scales), launches


def surface_pipeline(card, base):
    """The uncertainty benchmarks (BayesianFCN, seeded weights, on
    AddRandomObjects over UnittestData and on UnittestData), training of
    the rgb and depth SimpleFCN, finetuning ``rgb_to_depth`` of the rgb
    run, a FusionFCN step and the progressive depth column from its
    translated rgb column, and the IBCC dump of the two experts. Returns
    {what: seconds}."""
    from modular_semantic_segmentation_torch import settings
    from modular_semantic_segmentation_torch.experiments import (
        finetuning, ibcc_fusion, train_and_evaluate_progressive, training,
        uncertainty_eval)
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.utils.experiment import \
        ExperimentData
    seconds, runs = {}, {}

    def run(what, module, command, config):
        start = time.perf_counter()
        module.ex.run(command, config_updates=dict(config, device="cuda",
                                                   seed=1))
        torch.cuda.synchronize()
        seconds[what] = time.perf_counter() - start
        runs[what] = module.ex.current_run._id
        return module.ex.current_run.info

    write_object_library(base)
    settings.DATA_BASEPATH = base
    data = {"name": "unittest", **SURFACE_DATA}
    ood = dict(data, name="add_random_objects", add_to_dataset="unittest")
    net = get_model("bayesian_fcn")(data_description=(
        {"rgb": np.float32, "labels": np.int32},
        {"rgb": (None, None, 3), "labels": (None, None)}, SURFACE_CLASSES),
        device="cuda", seed=4, **SURFACE_BAYESIAN)
    weights = net.export_weights(base)
    common = {"modelname": "bayesian_fcn", "net_config": SURFACE_BAYESIAN,
              "starting_weights": weights}
    info = run("uncertainty_benchmark", uncertainty_eval, "main", dict(
        common, dataset=ood, benchmark="out_of_distribution",
        uncertainty_metrics=["entropy"]))
    auroc = info["measurements"]["entropy"]["AUROC"]
    check(0.0 <= auroc <= 1.0, f"out-of-distribution AUROC {auroc}")
    info = run("measure", uncertainty_eval, "measure", dict(
        common, dataset=data, uncertainty_metrics=["entropy", "variance"]))
    measured = info["measurements"]
    check(np.isfinite(measured["nll"]), f"measure: NLL {measured['nll']}")
    for m in MODALITIES:
        run(f"training {m}", training, "main", {
            "modelname": "simple_fcn", "num_iterations": SURFACE_STEPS,
            "starting_weights": False, "dataset": data,
            "net_config": dict(SURFACE_NET, prefix=m, modality=m)})
    eval_data = {"dataset": "unittest", **SURFACE_DATA}
    run("finetuning rgb_to_depth", finetuning, "rgb_to_depth", {
        "starting_weights": {"experiment_id": runs["training rgb"]},
        "data_config": eval_data, "num_iterations": SURFACE_STEPS,
        "net_config": dict(SURFACE_NET, prefix="rgb", modality="depth")})
    with np.load(ExperimentData(runs["finetuning rgb_to_depth"]
                                ).get_weights()) as npz:
        check(npz["rgb/conv1_1/kernel"].shape[2] == 1, "finetuning "
              "rgb_to_depth: the first kernel is not one channel wide")
    run("training fusion_fcn", training, "main", {
        "modelname": "fusion_fcn", "num_iterations": 1,
        "starting_weights": False, "dataset": data,
        "net_config": dict(SURFACE_NET, prefixes={m: m for m in MODALITIES})})
    run("progressive rgb_to_depth", train_and_evaluate_progressive,
        "rgb_to_depth", {
            "starting_weights": {"experiment_id": runs[
                "training fusion_fcn"]},
            "data_config": eval_data, "num_iterations": SURFACE_STEPS,
            "net_config": dict(SURFACE_NET, prefix="depth",
                               modality="depth",
                               lateral_columns={"rgb": "depth"})})
    with np.load(ExperimentData(runs["training fusion_fcn"]).get_weights()
                 ) as a, np.load(ExperimentData(runs[
                     "progressive rgb_to_depth"]).get_weights()) as b:
        check(np.array_equal(b["rgb_conv1_1/kernel"], a[
            "rgb_conv1_1/kernel"].mean(2, keepdims=True)),
              "progressive rgb_to_depth: the lateral column's first kernel "
              "is not the translated rgb column's")
    save_to = os.path.join(base, "ibcc")
    run("ibcc_fusion", ibcc_fusion, "main", {
        "net_config": dict(SURFACE_NET, expert_model="fcn",
                           prefixes={m: m for m in MODALITIES}),
        "dataset": data, "save_to": save_to,
        "starting_weights": {m: runs[f"training {m}"] for m in MODALITIES}})
    with np.load(os.path.join(save_to, "predictions.npz")) as npz:
        for m in MODALITIES:
            labels = npz[f"test_{m}"]
            check(labels.shape == npz["test_gt"].shape
                  and labels.min() >= 0 and labels.max() < SURFACE_CLASSES,
                  f"ibcc_fusion: test_{m} of shape {labels.shape}")
    print(f"uncertainty benchmarks (BayesianFCN, seeded weights, {HEIGHT}x"
          f"{WIDTH}, {SURFACE_CLASSES} classes): out-of-distribution "
          f"AUROC of entropy {auroc:.4f} on AddRandomObjects over "
          f"UnittestData; measure: NLL {measured['nll']:.4f}, entropy mean "
          f"{measured['entropy']['mean']:.4f}, variance mean "
          f"{measured['variance']['mean']:.4f}")
    print("experiment surface runs (seconds, host clock, synchronised): "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f" on {card}")
    return seconds


def experiment_surface(card):
    """Phase 18 in a temporary store: the timing rows and their Table V,
    the int8 AdapNet agreement and the surface's CLIs, every score's
    counts (the offline evaluation's among them) held against kernel A's
    plain version once the phase's runs are done. Returns kernel A's
    launches on the phase."""
    import tempfile
    from modular_semantic_segmentation_torch import settings
    from modular_semantic_segmentation_torch.ops.cuda import confusion
    saved = (settings.EXPERIMENT_STORAGE_FOLDER, settings.EXP_OUT,
             settings.DATA_BASEPATH)
    with tempfile.TemporaryDirectory() as base:
        settings.EXPERIMENT_STORAGE_FOLDER = os.path.join(base, "experiments")
        settings.EXP_OUT = os.path.join(base, "exp")
        confusion.KERNEL.launches = 0
        try:
            with KernelChecks() as checks:
                surface_timing(card)
                int8_adapnet_agreement(card)
                surface_pipeline(card, base)
            launches = confusion.KERNEL.launches
        finally:
            (settings.EXPERIMENT_STORAGE_FOLDER, settings.EXP_OUT,
             settings.DATA_BASEPATH) = saved
    print(f"experiment surface kernel checks: {checks.scores} scores with "
          "kernel A's counts equal to its plain version's")
    return launches


def main():
    times = {}

    def timed(label, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        times[label] = time.perf_counter() - start
        print(f"phase {label}: {times[label]:.1f} s")
        return result

    name, count, smi_line = timed("device", phase_device)
    from modular_semantic_segmentation_torch.ops.cuda import (
        confusion, dirichlet, stem_conv)
    from modular_semantic_segmentation_torch.ops.layers import \
        configure_float32
    configure_float32()
    timed("build", phase_build)
    for kind in ("uniform", "one bin"):
        timed(f"confusion check, {kind}", check_confusion, smi_line, kind,
              *confusion_pairs(kind))
    records = [timed("dirichlet check", check_dirichlet, smi_line),
               timed("stem conv check", check_stem_conv, smi_line)]
    kernels = (confusion.KERNEL, dirichlet.KERNEL)

    # ---- the main path: launch counts from 0
    for kernel in kernels:
        kernel.launches = 0
    experts = build_experts()
    frames = make_frames(1, MEASURE_FRAMES)

    def measure():
        cms = {}
        for m in MODALITIES:
            measures, cms[m] = experts[m].score(frames)
            check(np.isfinite(measures["total_accuracy"]),
                  f"{m}: non-finite accuracy")
        return cms

    cms = timed("measure step", measure)
    n_labelled = int((frames["labels"] >= 0).sum())
    measure_launches = confusion.KERNEL.launches
    print(f"measure step: confusion sums rgb {cms['rgb'].sum():.0f}, depth "
          f"{cms['depth'].sum():.0f} (labelled pixels {n_labelled}); "
          f"confusion launches {measure_launches}")
    for m in MODALITIES:
        check(cms[m].sum() == n_labelled, f"{m}: confusion matrix counts "
              f"{cms[m].sum()} pixels, the labels have {n_labelled}")
    check(measure_launches > 0, "the measure step launched no confusion "
          "kernel")

    dirich = fusion_model("dirichlet_fusion", experts, use_pallas=True,
                          compute_dtype="bfloat16")
    params = timed("Dirichlet fit", fit_dirichlet, dirich, frames,
                   smi_line)

    serve_frames = [{"rgb": frames["rgb"][i % MEASURE_FRAMES],
                     "depth": frames["depth"][i % MEASURE_FRAMES]}
                    for i in range(SERVE_FRAMES)]
    bayes = fusion_model("bayes_fusion", experts, confusion_matrices=cms,
                         compute_dtype="bfloat16")
    out, bayes_ms = timed("Bayes serving", serve, bayes, serve_frames)
    check_labels(out, "Bayes serving")
    print(f"Bayes serving: {_runs(bayes_ms)} ms/frame over {SERVE_FRAMES} "
          f"frames at {HEIGHT}x{WIDTH}, bf16, unroll {UNROLL} (host clock, "
          f"synchronised; three runs after a warm-up) on {smi_line}")

    before = dirichlet.KERNEL.launches
    stacks = []
    real_stack = torch.stack

    def counted_stack(*args, **kwargs):
        stacks.append(1)
        return real_stack(*args, **kwargs)

    torch.stack = counted_stack  # the kernel reads the experts in place
    try:
        out, dirichlet_ms = timed("Dirichlet serving", serve, dirich,
                                  serve_frames)
    finally:
        torch.stack = real_stack
    check(not stacks, f"Dirichlet serving called torch.stack {len(stacks)} "
          "times")
    check_labels(out, "Dirichlet serving")
    dirichlet_launches = dirichlet.KERNEL.launches - before
    print(f"Dirichlet serving: {_runs(dirichlet_ms)} ms/frame over "
          f"{SERVE_FRAMES} frames at {HEIGHT}x{WIDTH}, bf16, unroll "
          f"{UNROLL}, fitted parameters, dirichlet launches "
          f"{dirichlet_launches}, torch.stack calls 0 (host clock, "
          f"synchronised; three runs after a warm-up) on {smi_line}")
    check(dirichlet_launches >= SERVE_FRAMES,
          f"Dirichlet serving launched the kernel {dirichlet_launches} "
          f"times for {SERVE_FRAMES} frames")

    launches = {k.source: k.launches for k in kernels}
    # ---- end of the main path

    # ---- the stem conv's path: its launch count from 0
    stem_conv.KERNEL.launches = 0
    timed("stem conv", stem_conv_path, experts["rgb"], frames, smi_line)
    launches[stem_conv.KERNEL.source] = stem_conv.KERNEL.launches
    # ---- end of the stem conv's path

    # kernel A on the measure step's own pairs: the measure frames' labels
    # and the rgb expert's int32 predictions on them; its record
    predictions = torch.from_numpy(experts["rgb"].predict(frames)).cuda()
    records.insert(0, timed(
        "confusion check, measure step", check_confusion, smi_line,
        "measure step", predictions.reshape(-1),
        torch.from_numpy(frames["labels"]).cuda().reshape(-1)))
    timed("measure step launches", measure_step_launches, experts["rgb"],
          frames, smi_line)

    # ---- the fusion family's path: the launch counts from 0
    for kernel in kernels:
        kernel.launches = 0
    timed("fusion family", fusion_family, experts, frames, params, cms,
          smi_line)
    check(confusion.KERNEL.launches > 0, "the fusion family launched no "
          "confusion kernel")
    print(f"fusion family path: confusion launches "
          f"{confusion.KERNEL.launches}")
    # ---- end of the fusion family's path
    int8_records, _ = timed("int8 serving", int8_serving, bayes, dirich,
                            frames, serve_frames, smi_line)
    timed("profile", lambda: (serving_profile(bayes, serve_frames, "Bayes"),
                              serving_profile(dirich, serve_frames,
                                              "Dirichlet")))
    # ---- the training path: kernel A's launch count from 0 (in training)
    timed("training", training, smi_line)
    # ---- end of the training path

    # ---- the AdapNet serving path: the launch counts from 0
    for kernel in kernels:
        kernel.launches = 0
    adapnets, adapnet_cms = timed("AdapNet serving", adapnet_serving, frames,
                                  smi_line)
    adapnet_launches = {k.source: k.launches for k in kernels}
    # ---- end of the AdapNet serving path
    print(f"AdapNet serving path: confusion launches "
          f"{adapnet_launches['confusion']}, dirichlet launches "
          f"{adapnet_launches['dirichlet']}")
    check(all(adapnet_launches.values()), "the AdapNet serving path did "
          f"not launch every kernel of its path: {adapnet_launches}")
    # ---- the other architectures' training path: kernel A's count from 0
    confusion.KERNEL.launches = 0
    timed("other architectures, training", other_training, smi_line)
    trained_launches = confusion.KERNEL.launches
    # ---- end of the other architectures' training path
    print(f"other architectures, training path: confusion launches "
          f"{trained_launches}")
    check(trained_launches > 0, "the other architectures' training path "
          "launched no confusion kernel")
    timed("AdapNet reference checks", adapnet_reference_checks, adapnets,
          adapnet_cms)
    timed("AdapNet step conditioning", adapnet_step_conditioning, smi_line)
    timed("reference checks", reference_checks, experts, bayes, dirich)
    # ---- the experiment pipeline's path: its launch counts are set to 0
    # and read inside experiment_pipeline
    pipeline_launches, _ = timed("experiment pipeline", experiment_pipeline,
                                 smi_line)
    # ---- end of the experiment pipeline's path
    print(f"experiment pipeline path: confusion launches "
          f"{pipeline_launches['confusion']}, dirichlet launches "
          f"{pipeline_launches['dirichlet']}")
    check(all(pipeline_launches.values()), "the experiment pipeline did not "
          f"launch every kernel of its path: {pipeline_launches}")
    # ---- the training input pipeline's path: kernel A's count is set to 0
    # and read inside input_pipeline
    input_launches = timed("input pipeline", input_pipeline, smi_line)
    # ---- end of the training input pipeline's path
    check(input_launches > 0, "the input pipeline launched no confusion "
          "kernel")
    # ---- the experiment surface's path: kernel A's count is set to 0 and
    # read inside experiment_surface
    surface_launches = timed("experiment surface", experiment_surface,
                             smi_line)
    # ---- end of the experiment surface's path
    print(f"experiment surface path: confusion launches {surface_launches}")
    check(surface_launches > 0, "the experiment surface launched no "
          "confusion kernel")
    for record in records:
        record["launches"] = launches[record["name"]]
        check(record["launches"] > 0,
              f"kernel {record['name']} was not launched on the main path")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    # the int8 product is a library call, not a kernel of the port
    print(json.dumps({"int8_product": int8_records}))
    print(json.dumps({"kernels": [{key: r[key] for key in order}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:  # report any fault and exit non-zero, no result line
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
