"""Inference-timing harness (the port's counterpart of the JAX package's
``experiments/timing.py``, the paper's Table V).

    python -m modular_semantic_segmentation_torch.experiments.timing \\
        [command] with [key=value ...] [device=cpu]

Every command builds its model with seeded random weights and times
inference of a constant 1x768x384 frame already on the device
(host-to-device copies excluded), under ``torch.inference_mode()``, with
``utils/profiling.time_fn``: the mean and spread of synchronised calls,
and the pipelined time per frame of calls queued back to back. Results go
into the run's ``info["timings"][<name>]`` with the JAX package's keys,
so either package's ``report timing_table`` reads the other's runs.

Defaults: num_units 64, 14 classes, 50 repetitions, bfloat16 compute.
``main`` times the Table V sweep (the SimpleFCN family); ``time_serving``
times the ``InferenceServer`` group of any model; ``time_train_step`` a
train step (``device_time_fn``); ``time_offline_eval`` a whole ``score``.
"""

import time

import numpy as np

from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import \
    get_observer

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())

HEIGHT, WIDTH = 768, 384

DEFAULTS = dict(num_units=64, num_classes=14, repetitions=50,
                compute_dtype="bfloat16", num_samples=5, dropout_rate=0.2,
                int8=False, height=HEIGHT, width=WIDTH, device="cuda")


def _cfg(overrides):
    cfg = dict(DEFAULTS)
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


def _description(num_classes):
    return ({"labels": np.int32, "rgb": np.float32, "depth": np.float32},
            {"rgb": (None, None, 3), "depth": (None, None, 1),
             "labels": (None, None)}, num_classes)


def _inputs(modalities, cfg=None):
    h = (cfg or DEFAULTS)["height"]
    w = (cfg or DEFAULTS)["width"]
    shapes = {"rgb": (1, h, w, 3), "depth": (1, h, w, 1)}
    return {m: np.ones(shapes[m], np.float32) for m in modalities}


def _time(net, batch, cfg):
    """``time_fn`` of the model's forward on ``batch`` copied to its
    device; with ``int8`` the model is calibrated on that batch first."""
    from modular_semantic_segmentation_torch.utils.profiling import time_fn

    if cfg.get("int8"):
        # calibration inputs do not matter for timing; the int8 labels are
        # held against the JAX package's in tests/test_torch_timing.py
        net.quantize_for_serving(batch, num_batches=1)
    device_batch = net._batch_to_device(batch)

    def forward():
        return net._forward(device_batch)["prediction"]

    result = time_fn(forward, repetitions=cfg["repetitions"])
    print(f"{net.name}: {result['pipelined_mean_s']:.4f} s/frame pipelined "
          f"({result['pipelined_fps']:.1f} fps); "
          f"{result['sync_mean_s']:.4f} +- {result['sync_std_s']:.4f} "
          "s/frame sync")
    return result


def _expert_config(cfg, modality):
    return dict(prefix=modality, modality=modality,
                num_units=cfg["num_units"],
                data_description=_description(cfg["num_classes"]),
                compute_dtype=cfg["compute_dtype"],
                batch_normalization=False, device=cfg["device"])


def _fusion_config(cfg, **extra):
    base = dict(data_description=_description(cfg["num_classes"]),
                num_units=cfg["num_units"], expert_model="fcn",
                prefixes={"rgb": "rgb", "depth": "depth"},
                compute_dtype=cfg["compute_dtype"], device=cfg["device"])
    base.update(extra)
    return base


def _random_cms(num_classes, seed=0):
    rng = np.random.RandomState(seed)
    return {m: rng.rand(num_classes, num_classes) + np.eye(num_classes) * 5
            for m in ("rgb", "depth")}


def _dirichlet_params(num_classes):
    rng = np.random.RandomState(0)
    params = {m: rng.rand(num_classes, num_classes).astype("float32") + 1
              for m in ("rgb", "depth")}
    params["class_counts"] = np.ones(num_classes, "float32")
    return params


def _adapnet(cfg, modality="rgb"):
    kwargs = _expert_config(cfg, modality)
    del kwargs["batch_normalization"]  # AdapNet always batch-normalizes
    return get_model("adapnet")(**kwargs)


_BOTH = ["rgb", "depth"]

#: model name -> (build(cfg) -> net, modalities): the model of each
#: command, the name its timing is recorded under, and ``time_serving``'s
#: ``model``
BUILDERS = {
    "rgb_fcn": (lambda cfg: get_model("simple_fcn")(
        **_expert_config(cfg, "rgb")), ["rgb"]),
    "depth_fcn": (lambda cfg: get_model("simple_fcn")(
        **_expert_config(cfg, "depth")), ["depth"]),
    "adapnet": (_adapnet, ["rgb"]),
    "average_fcn": (lambda cfg: get_model("average")(
        **_fusion_config(cfg)), _BOTH),
    "bayes_fcn": (lambda cfg: get_model("bayes_mix")(**_fusion_config(
        cfg, confusion_matrices=_random_cms(cfg["num_classes"]))), _BOTH),
    "bayes_adapnet": (lambda cfg: get_model("bayes_mix")(**_fusion_config(
        cfg, confusion_matrices=_random_cms(cfg["num_classes"]),
        expert_model="adapnet")), _BOTH),
    "bayes_lookup_fcn": (lambda cfg: get_model("bayes_mix")(
        **_fusion_config(cfg,
                         confusion_matrices=_random_cms(cfg["num_classes"]),
                         use_decision_matrix=True)), _BOTH),
    "dirichlet_fcn": (lambda cfg: get_model("dirichlet_mix")(
        **_fusion_config(cfg,
                         dirichlet_params=_dirichlet_params(
                             cfg["num_classes"]), sigma=0.2)), _BOTH),
    "fusion_fcn": (lambda cfg: get_model("fusion_fcn")(
        data_description=_description(cfg["num_classes"]),
        prefixes={"rgb": "rgb", "depth": "depth"},
        num_units=cfg["num_units"], compute_dtype=cfg["compute_dtype"],
        device=cfg["device"]), _BOTH),
    "variance_fcn": (lambda cfg: get_model("variance")(**_fusion_config(
        cfg, num_samples=cfg["num_samples"],
        dropout_rate=cfg["dropout_rate"])), _BOTH),
}


def _time_model(_run, name, cfg):
    build, modalities = BUILDERS[name]
    _record(_run, name, _time(build(cfg), _inputs(modalities, cfg), cfg))


def _record(_run, name, result):
    _run.info.setdefault("timings", {})[name] = result


@ex.command
def time_rgb_fcn(_run, num_units=None, num_classes=None, repetitions=None,
                 compute_dtype=None, int8=None, height=None, width=None,
                 device="cuda"):
    _time_model(_run, "rgb_fcn", _cfg(locals()))


@ex.command
def time_depth_fcn(_run, num_units=None, num_classes=None, repetitions=None,
                   compute_dtype=None, int8=None, height=None, width=None,
                   device="cuda"):
    _time_model(_run, "depth_fcn", _cfg(locals()))


@ex.command
def time_fusion_fcn(_run, num_units=None, num_classes=None, repetitions=None,
                    compute_dtype=None, int8=None, height=None, width=None,
                    device="cuda"):
    _time_model(_run, "fusion_fcn", _cfg(locals()))


@ex.command
def time_average_fcn(_run, num_units=None, num_classes=None,
                     repetitions=None, compute_dtype=None, int8=None,
                     height=None, width=None, device="cuda"):
    _time_model(_run, "average_fcn", _cfg(locals()))


@ex.command
def time_bayes_fcn(_run, num_units=None, num_classes=None, repetitions=None,
                   compute_dtype=None, int8=None, height=None, width=None,
                   device="cuda"):
    _time_model(_run, "bayes_fcn", _cfg(locals()))


@ex.command
def time_bayes_adapnet(_run, num_units=None, num_classes=None,
                       repetitions=None, compute_dtype=None, int8=None,
                       height=None, width=None, device="cuda"):
    """Bayes fusion of AdapNet experts, the architecture of the paper's
    quality tables I-III (its Table V times the SimpleFCN family only)."""
    _time_model(_run, "bayes_adapnet", _cfg(locals()))


@ex.command
def time_bayes_lookup_fcn(_run, num_units=None, num_classes=None,
                          repetitions=None, compute_dtype=None, int8=None,
                          height=None, width=None, device="cuda"):
    """Bayes fusion through its precomputed decision matrix
    (``use_decision_matrix``)."""
    _time_model(_run, "bayes_lookup_fcn", _cfg(locals()))


@ex.command
def time_dirichlet_fcn(_run, num_units=None, num_classes=None,
                       repetitions=None, compute_dtype=None, int8=None,
                       height=None, width=None, device="cuda"):
    _time_model(_run, "dirichlet_fcn", _cfg(locals()))


@ex.command
def time_variance_fcn(_run, num_units=None, num_classes=None,
                      repetitions=None, compute_dtype=None,
                      num_samples=None, dropout_rate=None, int8=None,
                      height=None, width=None, device="cuda"):
    _time_model(_run, "variance_fcn", _cfg(locals()))


@ex.command
def time_adapnet(_run, num_units=None, num_classes=None, repetitions=None,
                 compute_dtype=None, int8=None, modality="rgb",
                 device="cuda"):
    """AdapNet alone, recorded as ``adapnet_<modality>``, at 768x384."""
    cfg = _cfg(dict(num_units=num_units, num_classes=num_classes,
                    repetitions=repetitions, compute_dtype=compute_dtype,
                    int8=int8, device=device))
    _record(_run, f"adapnet_{modality}", _time(
        _adapnet(cfg, modality), _inputs([modality], cfg), cfg))


@ex.command
def time_serving(_run, model="bayes_fcn", unroll=4, num_units=None,
                 num_classes=None, repetitions=None, compute_dtype=None,
                 int8=None, height=None, width=None, device="cuda"):
    """The serving loop's group: ``InferenceServer(unroll=...)
    .group_program`` over ``unroll`` batch-1 frames on the device, timed
    as the JAX package times its group program (``repetitions //
    unroll`` groups); per frame, the pipelined time over ``unroll``.
    ``model`` is a name of ``BUILDERS``."""
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils.profiling import time_fn

    cfg = _cfg(dict(num_units=num_units, num_classes=num_classes,
                    repetitions=repetitions, compute_dtype=compute_dtype,
                    int8=int8, height=height, width=width, device=device))
    build, modalities = BUILDERS[model]
    net = build(cfg)
    batch = _inputs(modalities, cfg)
    if cfg["int8"]:
        net.quantize_for_serving(batch, num_batches=1)
    program = InferenceServer(net, unroll=unroll).group_program
    group = [net._batch_to_device(batch) for _ in range(unroll)]
    result = time_fn(program, group,
                     repetitions=max(1, cfg["repetitions"] // unroll))
    per_frame = result["pipelined_mean_s"] / unroll
    result = dict(result, serving_s_per_frame=float(per_frame),
                  serving_fps=float(1.0 / per_frame), unroll=unroll)
    print(f"{net.name} serving (unroll={unroll}): {per_frame:.4f} s/frame "
          f"({1.0 / per_frame:.1f} fps)")
    _record(_run, f"serving_{model}" + ("_int8" if cfg["int8"] else ""),
            result)


@ex.command
def time_train_step(_run, num_units=None, num_classes=None,
                    repetitions=None, compute_dtype=None, batchsize=1,
                    augment=False, height=HEIGHT, width=WIDTH,
                    model="simple_fcn", microbatch=0, remat=False,
                    device="cuda"):
    """One train step (forward, backward, adam, BN statistics) on constant
    frames, ``model`` in {simple_fcn, adapnet}; ``augment=True`` adds the
    on-device augmentation (scale, crop to ``width``, hflip, gamma),
    ``microbatch`` the gradient accumulation over microbatches of that
    size, ``remat`` the recomputation of the forward in the backward.
    Timed with ``device_time_fn`` (8 against 32 steps), every step on the
    same variables and batch."""
    from modular_semantic_segmentation_torch.utils.profiling import \
        device_time_fn

    cfg = _cfg(dict(num_units=num_units, num_classes=num_classes,
                    repetitions=repetitions, compute_dtype=compute_dtype,
                    device=device))
    kwargs = _expert_config(cfg, "rgb")
    kwargs["batch_normalization"] = True
    if model == "adapnet":
        del kwargs["batch_normalization"]  # AdapNet always batch-normalizes
    if augment:
        kwargs["device_augmentation"] = dict(
            scale=(0.4, 0.7, 1.5), crop=(1.0, width), hflip=0.5,
            gamma=(0.4, 0.3, 1.2))
    if microbatch:
        kwargs["microbatch_size"] = int(microbatch)
    if remat:
        kwargs["remat"] = True
    net = get_model(model)(batchsize=batchsize, **kwargs)
    rng = np.random.RandomState(0)
    batch = net._batch_to_device({
        "rgb": np.asarray(rng.rand(batchsize, height, width, 3) * 255,
                          np.float32),
        "labels": rng.randint(0, cfg["num_classes"],
                              (batchsize, height, width)).astype(np.int32)})
    spf = device_time_fn(net._train_step, net.variables, net.opt_state,
                         batch, iters=8, repetitions=cfg["repetitions"])
    result = {"s_per_step": spf, "img_per_s": batchsize / spf,
              "batchsize": batchsize, "augment": bool(augment),
              "model": model, "microbatch": int(microbatch)}
    print(f"{model} train step (batch {batchsize}, "
          f"augment={bool(augment)}): "
          f"{spf:.4f} s/step, {batchsize / spf:.1f} img/s")
    _record(_run, "train_step" if model == "simple_fcn"
            else f"train_step_{model}", result)


@ex.command
def time_offline_eval(_run, num_units=None, num_classes=None,
                      compute_dtype=None, int8=None, batchsize=8,
                      num_frames=100, height=HEIGHT, width=WIDTH,
                      device="cuda"):
    """Offline evaluation: frames per second of a whole ``score`` (kernel
    A) over a synthetic corpus made before the clock starts, batching,
    padding, host-to-device copies and the confusion counts included.
    The corpus goes up compact, as the JAX package's: uint8 rgb and int8
    labels."""
    from modular_semantic_segmentation_torch.datasets.unittest_data import \
        UnittestData

    cfg = _cfg(dict(num_units=num_units, num_classes=num_classes,
                    compute_dtype=compute_dtype, int8=int8, device=device))
    k = min(cfg["num_classes"], 8)
    data = UnittestData(height=height, width=width, num_train=4,
                        num_measure=4, num_test=num_frames, num_classes=k)
    kwargs = _expert_config(cfg, "rgb")
    kwargs["data_description"] = UnittestData.get_data_description(
        num_classes=k)
    net = get_model("simple_fcn")(batchsize=batchsize, **kwargs)
    if cfg.get("int8"):
        net.quantize_for_serving(data.get_measureset(), num_batches=1)
    corpus = data.get_testset(tf_dataset=False)
    corpus["rgb"] = corpus["rgb"].astype(np.uint8)
    corpus["labels"] = corpus["labels"].astype(np.int8)
    net.score(corpus, max_iterations=1)  # warm up
    start = time.perf_counter()
    net.score(corpus)
    wall = time.perf_counter() - start
    result = {"s_total": wall, "img_per_s": num_frames / wall,
              "num_frames": num_frames, "batchsize": batchsize,
              "int8": bool(cfg.get("int8"))}
    print(f"offline eval: {num_frames} frames in {wall:.2f} s = "
          f"{num_frames / wall:.1f} img/s (batch {batchsize}, "
          f"pre-materialized corpus)")
    _record(_run, "offline_eval", result)


@ex.main
def main(_run, num_units=None, num_classes=None, repetitions=None,
         compute_dtype=None, int8=None, height=None, width=None,
         device="cuda"):
    """Time every configuration of the paper's Table V, at 768x384
    whatever ``height`` and ``width`` say, as the JAX package's ``main``."""
    for cmd in [time_rgb_fcn, time_depth_fcn, time_average_fcn,
                time_bayes_fcn, time_bayes_lookup_fcn, time_dirichlet_fcn,
                time_fusion_fcn, time_variance_fcn]:
        cmd(_run=_run, num_units=num_units, num_classes=num_classes,
            repetitions=repetitions, compute_dtype=compute_dtype, int8=int8,
            device=device)


if __name__ == "__main__":
    ex.run_commandline()
