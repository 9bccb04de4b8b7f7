"""Estimator: the runtime shared by every model of the port.

Counterpart of the JAX package's ``models/estimator.py``: config handling
and ``compute_dtype``, ``_preprocess`` (``input_scaling`` and integer
promotion), the train step and ``fit``, the eval step, ``predict``,
``score`` (partial batches padded with label -1), int8 post-training-
quantized serving (``quantize_for_serving`` / ``dequantize_serving``),
npz ``import_weights`` / ``export_weights``, the ``checkpoint.pkl``
files of ``save_checkpoint`` / ``load_weights``, and ``close`` with the
context manager.

Variables are a flat ``{tf_name: float32 tensor}`` store on ``device``,
made from the subclass's variable specs and a numpy seed (config ``seed``,
default 0); the specs also give ``trainable``, the ``{name: bool}`` map of
what the optimizer updates. The same seed starts the model's
``torch.Generator`` on ``device``, the random stream of its stochastic
layers (MC dropout); it advances with every draw, as the JAX package's key
is split per step. PyTorch runs eagerly, so there is no jitted step: the
eval step is a plain call under ``torch.inference_mode``, and the train
step is a pure function of (variables, optimizer state, batch) that
returns new tensors, as JAX's: no variable is changed in place
(``_kernel_cache``, an ``ops.layers.KernelCache``, relies on it).

Subclass contract:
    _variable_specs() -> [(name, shape, initializer, trainable), ...]
    _train_outputs(ctx, batch) -> dict with 'loss' (labels arrive
        one-hot, float32)
    _test_outputs(ctx, batch) -> dict with 'prediction' (+ 'prob', ...)
An eval-only model (``custom_training=True``) needs no _train_outputs.

The parallel layer (``parallel/``) distributes a model over the ranks of
a mesh by setting ``_parallel`` (``distribute``, ``distribute_spatial``,
``distribute_tp``), where the JAX package re-jits its steps with
shardings. Each rank then runs the same steps on its block of each global
batch (``_parallel.shard``) in a context over the mesh's axes
(``_parallel.ctx_kwargs``); the train step averages the gradients over
the axes (``_parallel.reduce_grads``), ``predict`` gathers the outputs,
and ``score`` sums the ranks' counts. The distribution survives
``quantize_for_serving`` / ``dequantize_serving``.
"""

import json
import os
import pickle
import time
from os import path

import numpy as np
import torch

from modular_semantic_segmentation_torch.models import params as params_lib
from modular_semantic_segmentation_torch.ops import device_augment
from modular_semantic_segmentation_torch.ops import metrics as metrics_lib
from modular_semantic_segmentation_torch.ops import optimizers
from modular_semantic_segmentation_torch.ops.init import (
    build_variables, trainable_map)
from modular_semantic_segmentation_torch.ops.layers import (
    KernelCache, configure_float32)
from modular_semantic_segmentation_torch.ops.losses import one_hot
from modular_semantic_segmentation_torch.ops.variables import (
    Ctx, resolve_device, resolve_dtype, split_trainable)
# to_numpy: imported from here by the models too
from modular_semantic_segmentation_torch.utils.data_io import (  # noqa: F401
    iterate_batches, prefetch_eval_batches, to_device_prefetched,
    to_numpy, training_batches)
from modular_semantic_segmentation_torch.utils.tfevents import EventWriter
from modular_semantic_segmentation_torch.utils import tracing


def _remat(loss_fn, generator):
    """``loss_fn(tvars)`` under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward pass instead of kept (the JAX package's
    ``jax.checkpoint``).

    The checkpoint restores the global RNG states for the recompute, not
    a ``torch.Generator``: the recompute would draw new dropout masks from
    the model's generator. So the generator's state at the start of the
    forward is set again for the recompute, and its state after the
    forward is put back when the recompute ends. The recompute's own
    return value (its recorded BN updates among it) is discarded by the
    checkpoint; the forward's stands.
    """
    from torch.utils.checkpoint import checkpoint
    start = []

    def replayed(names, *tensors):
        tvars = dict(zip(names, tensors))
        if not start:
            start.append(generator.get_state())
            return loss_fn(tvars)
        after = generator.get_state()
        generator.set_state(start[0])
        try:
            return loss_fn(tvars)
        finally:
            generator.set_state(after)

    def checkpointed(tvars):
        return checkpoint(replayed, list(tvars), *tvars.values(),
                          use_reentrant=False)
    return checkpointed


class Estimator:
    """Base class for all models. See module docstring.

    Args:
        data_description: (dtypes, shapes, num_classes), as a dataset's
            ``get_data_description()`` gives it.
        compute_dtype: 'float32' | 'bfloat16', the dtype inside the convs.
        device: where variables live and the model runs; 'cuda' (the
            default) raises when there is no card.
        custom_training: True for eval-only models (the fusion models):
            no optimizer, and ``fit`` raises UserWarning.
        config: the JAX package's keys, among them ``seed``; for
            training ``trainer`` ('adam' | 'adagrad' | 'rmsprop'),
            ``learning_rate`` (0.0001), ``microbatch_size``, ``remat``,
            ``checkpoint_interval``, ``abort_at_iou``,
            ``device_augmentation`` (the keyword arguments of
            ``ops/device_augment.augment_batch``) and ``loader_workers``
            (the size of ``fit``'s assembly pool, default the host's
            cores).
    """

    #: whether ``_test_outputs`` runs FCN expert stems through
    #: ``models/packed_experts.py`` where it applies; quantize_for_serving
    #: judges stem convs at the packed width only for such classes
    packs_expert_stems = False

    #: default ``min_pixels`` of quantize_for_serving, the JAX package's:
    #: 2048 (its AdapNet floor); the VGG/FCN family overrides it to 0
    ptq_min_pixels = 2048

    def __init__(self, data_description, name=None, output_dir=None,
                 custom_training=False, batchsize=1, compute_dtype="float32",
                 device="cuda", **config):
        self.name = name if name is not None else type(self).__name__
        self.output_dir = output_dir
        self.custom_training = custom_training
        self.config = config
        self.config["batchsize"] = batchsize
        self.config["num_classes"] = data_description[2]
        self.data_description = data_description
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.global_step = 0
        self._kernel_cache = KernelCache()
        # the parallel layer's distribution over a mesh (parallel/); None
        # on one device
        self._parallel = None
        # int8 PTQ serving: None = float path; set by quantize_for_serving
        self.act_scales = None
        configure_float32()
        seed = int(config.get("seed", 0))
        specs = self._variable_specs()
        self.variables = build_variables(specs, seed=seed,
                                         device=self.device)
        self.trainable = trainable_map(specs)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        if not self.custom_training:
            self._optimizer = optimizers.make_optimizer(
                self.config.get("trainer", "adam"),
                self.config.get("learning_rate", 0.0001))
            train_vars, _ = split_trainable(self.variables, self.trainable)
            self.opt_state = self._optimizer.init(train_vars)
        else:
            self._optimizer = None
            self.opt_state = None

    # ------------------------------------------------------------- contracts
    def _variable_specs(self):
        raise NotImplementedError

    def _train_outputs(self, ctx, batch):
        """Subclass contract: a dict with key 'loss'.

        With ``microbatch_size`` the loss must be the valid-pixel MEAN
        (normalized by the one-hot label count, as
        ``ops/losses.cross_entropy``): the microbatch accumulation weights
        each microbatch's gradient by its non-void pixel count, which
        gives the full-batch gradient only for that form of loss.
        """
        raise NotImplementedError

    def _test_outputs(self, ctx, batch):
        raise NotImplementedError

    def _input_channels(self, modality):
        channels = self.data_description[1][modality][-1]
        if channels is None:
            raise ValueError(f"data description gives no channel count for "
                             f"'{modality}'")
        return int(channels)

    # ----------------------------------------------------------------- steps
    def _batch_to_device(self, batch):
        """Host batch dict -> tensors on the model's device. To a card the
        copies go from pinned memory without blocking the host."""
        out = {}
        for key, value in batch.items():
            t = (value if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(value)))
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[key] = t
        return out

    def _preprocess(self, batch):
        """Input normalization on the device.

        config ``input_scaling``: {modality: scale | (scale, offset)}.
        Integer inputs (compact uint8 frames) are promoted to float32."""
        scaling = self.config.get("input_scaling") or {}
        out = dict(batch)
        for modality, value in batch.items():
            if modality == "labels":
                continue
            spec = scaling.get(modality)
            if spec is not None:
                scale, offset = (spec if isinstance(spec, (tuple, list))
                                 else (spec, 0.0))
                out[modality] = value.float() * scale + offset
            elif not value.is_floating_point():
                out[modality] = value.float()
        return out

    def _microbatch_grads(self, variables, batch):
        """Loss, non-void pixel weight, BN updates and gradients of the
        trainable variables for one (micro)batch on the device: the body
        of the plain and the microbatched train step.

        With config ``device_augmentation`` the (micro)batch is augmented
        first, from the model's generator, on raw [0, 255] frames and
        without gradients. That happens outside the region ``remat``
        recomputes, since ``torch.utils.checkpoint`` does not restore a
        generator's state."""
        augmentation = self.config.get("device_augmentation")
        axes = self._parallel_ctx()
        if augmentation:
            if axes.get("spatial_axis") is not None:
                raise NotImplementedError(
                    "device_augmentation resamples across the height axis "
                    "and cannot run under spatial partitioning")
            with torch.no_grad():
                batch = device_augment.augment_batch(self._generator, batch,
                                                     **augmentation)
        train_batch = self._preprocess(batch)
        train_batch["labels"] = one_hot(batch["labels"],
                                        self.config["num_classes"])
        train_vars, frozen_vars = split_trainable(variables, self.trainable)
        leaves = {k: v.detach().requires_grad_()
                  for k, v in train_vars.items()}

        def loss_fn(tvars):
            ctx = Ctx({**frozen_vars, **tvars},
                      compute_dtype=self.compute_dtype,
                      kernel_cache=self._kernel_cache,
                      generator=self._generator, train=True, **axes)
            out = self._train_outputs(ctx, train_batch)
            return out["loss"], ctx.updates

        if self.config.get("remat"):
            loss_fn = _remat(loss_fn, self._generator)
        with torch.enable_grad():
            loss, bn_updates = loss_fn(leaves)
            grads = (torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True,
                                         materialize_grads=True)
                     if leaves else ())
        weight = torch.sum(train_batch["labels"])
        if self._parallel is not None:
            # the non-void pixel count of the global (micro)batch
            self._parallel.sum_(weight)
        return (loss.detach(), weight, bn_updates,
                dict(zip(leaves, grads)))

    def _parallel_ctx(self):
        """The mesh axes of this rank's contexts (``Ctx`` keyword
        arguments); none on one device."""
        return {} if self._parallel is None else self._parallel.ctx_kwargs

    def _train_step(self, variables, opt_state, batch):
        """One optimizer step: (new variables, new optimizer state, loss).

        Pure, as the JAX package's: the inputs are not changed, and the
        trained variables and BN statistics are new tensors. With config
        ``microbatch_size`` smaller than the batch, the batch is split
        into strided microbatches (``i::steps``) whose gradients are
        accumulated weighted by their non-void pixel counts (the
        full-batch gradient of the valid-pixel mean loss), the loss
        likewise; batch norm then normalizes per microbatch and the moving
        statistics take the mean of the microbatches' updates.
        """
        batch = self._batch_to_device(batch)
        if self._parallel is not None:
            batch = self._parallel.shard(batch)
        micro = int(self.config.get("microbatch_size") or 0)
        batchsize = int(next(iter(batch.values())).shape[0])
        if micro and "spatial_axis" in self._parallel_ctx():
            raise NotImplementedError(
                "microbatch_size does not compose with spatial "
                "partitioning (distribute_spatial)")
        if micro and batchsize % micro:
            raise ValueError(f"microbatch_size={micro} must divide the "
                             f"batch size ({batchsize})")
        with tracing.span("fit.forward_backward", device=self.device):
            if micro and batchsize > micro:
                num, den, loss_sum, bn_acc = None, 0.0, 0.0, {}
                steps = batchsize // micro
                for i in range(steps):
                    part = {k: v[i::steps] for k, v in batch.items()}
                    loss_i, w, bn_i, g_i = self._microbatch_grads(
                        variables, part)
                    weighted = {k: g * w for k, g in g_i.items()}
                    num = weighted if num is None else {
                        k: num[k] + weighted[k] for k in num}
                    den = den + w
                    loss_sum = loss_sum + loss_i * w
                    for k, v in bn_i.items():
                        bn_acc.setdefault(k, []).append(v)
                scale = 1.0 / torch.clamp(den, min=1e-20)
                grads = {k: a * scale for k, a in num.items()}
                loss = loss_sum * scale
                bn_updates = {k: sum(vs) / len(vs)
                              for k, vs in bn_acc.items()}
            else:
                loss, _, bn_updates, grads = self._microbatch_grads(
                    variables, batch)
        if self._parallel is not None:
            grads = self._parallel.reduce_grads(grads)
        train_vars, _ = split_trainable(variables, self.trainable)
        with tracing.span("fit.optimizer", device=self.device):
            updates, opt_state = self._optimizer.update(grads, opt_state)
            train_vars = optimizers.apply_updates(train_vars, updates)
        return {**variables, **train_vars, **bn_updates}, opt_state, loss

    def _forward(self, batch):
        """Test outputs for a batch already on the device, in the current
        serving mode (``act_scales``)."""
        return self._forward_with_scales(batch, self.act_scales)

    def _forward_with_scales(self, batch, act_scales):
        """Test outputs for a batch already on the device, with the int8
        scales ``act_scales`` (None = float)."""
        with torch.inference_mode():
            ctx = Ctx(self.variables, compute_dtype=self.compute_dtype,
                      kernel_cache=self._kernel_cache,
                      generator=self._generator, act_scales=act_scales,
                      **self._parallel_ctx())
            return self._test_outputs(ctx, self._preprocess(batch))

    def _serving_state(self):
        """The objects the served forward reads besides its inputs and the
        serving mode: ``serving.InferenceServer`` replays a captured CUDA
        graph only while each is, by identity, the one it captured, and
        each tensor has not been written in place since."""
        return tuple(self.variables.values())

    def _eager_serving_reason(self):
        """Why ``serving.InferenceServer`` runs this model's groups eagerly
        rather than from a captured CUDA graph, or None. A family whose
        test forward draws from the model's generator, or copies host
        arrays to the device, says so."""
        return None

    def _eval_step(self, batch):
        """Test outputs and, with labels in the batch, its confusion
        matrix, for a batch on the device. Distributed, the outputs are
        the gathered global ones and the counts the ranks' sum."""
        local = batch if self._parallel is None else self._parallel.shard(
            batch)
        out = self._forward(local)
        if "labels" in batch:
            with torch.inference_mode():
                counts = metrics_lib.confusion_counts(
                    out["prediction"], local["labels"],
                    self.config["num_classes"])
                if self._parallel is not None:
                    self._parallel.sum_(counts)
                out["confusion_matrix"] = counts.float()
        if self._parallel is not None:
            out = {k: v if k == "confusion_matrix" else
                   self._parallel.gather(v) for k, v in out.items()}
        return out

    # ------------------------------------------------------------------- fit
    def fit(self, data, iterations, output=True, validation_dataset=None,
            validation_interval=100, additional_eval_datasets=None):
        """Train for ``iterations`` steps.

        Args:
            data: a data source (``batches(...)``), a dict of stacked
                arrays or an iterator of batch dicts; shuffled in an order
                fixed by config ``seed``.
            validation_dataset: scored every ``validation_interval``
                steps (from the first); a line is printed when ``output``,
                and with ``output_dir`` set a record goes to
                ``summaries.jsonl`` and to an event file there.
            additional_eval_datasets: {name: data}, whose mean IoU each
                record also holds.

        With ``output_dir`` and config ``checkpoint_interval``,
        ``checkpoint.pkl`` is written every that many steps; config
        ``abort_at_iou`` ends the fit once the validation mean IoU
        exceeds it.

        Batches are assembled in a pool of config ``loader_workers``
        threads (default: the host's cores) and copied to the device by a
        producer thread ahead of the step (``to_device_prefetched``).

        While a profiler records, each step's wait for its batch, the step
        and, inside it, the forward and backward and the optimizer's
        update are the spans ``fit.next_batch``, ``fit.step``,
        ``fit.forward_backward`` and ``fit.optimizer`` of
        ``utils/tracing.py`` (the last three with their stream time on a
        card), their request id the global step; the counter
        ``fit.steps`` counts the steps.
        """
        if self.custom_training:
            raise UserWarning(
                f"ERROR: Model {self.name} does not support training")
        additional_eval_datasets = additional_eval_datasets or {}
        workers = self.config.get("loader_workers", os.cpu_count())
        batches = to_device_prefetched(
            training_batches(data, self.config["batchsize"],
                             seed=int(self.config.get("seed", 0)),
                             workers=workers), self.device)
        summary_file = None
        event_writer = None
        if self.output_dir is not None:
            summary_file = open(path.join(self.output_dir,
                                          "summaries.jsonl"), "a")
            event_writer = EventWriter(self.output_dir)
        checkpoint_interval = self.config.get("checkpoint_interval")

        print("INFO: Start training")
        start = time.time()
        try:
            for i in range(iterations):
                step = self.global_step
                with tracing.span("fit.next_batch", request=step):
                    batch = next(batches)
                with tracing.span("fit.step", device=self.device,
                                  request=step):
                    self.variables, self.opt_state, loss = self._train_step(
                        self.variables, self.opt_state, batch)
                tracing.count("fit.steps")
                self.global_step += 1
                if (checkpoint_interval and self.output_dir is not None
                        and self.global_step % checkpoint_interval == 0):
                    self.save_checkpoint(
                        path.join(self.output_dir, "checkpoint.pkl"))
                if (i % validation_interval == 0
                        and validation_dataset is not None):
                    score, _ = self.score(validation_dataset)
                    if output:
                        print("{:4d}: loss {:.4f}, accuracy {:.2f}, IoU "
                              "{:.2f}".format(i, float(loss),
                                             score["total_accuracy"],
                                             score["mean_IoU"]))
                    record = {"step": self.global_step, "loss": float(loss),
                              "accuracy": float(score["total_accuracy"]),
                              "IoU": float(score["mean_IoU"]),
                              "wall_time": time.time() - start}
                    for key, extra_data in additional_eval_datasets.items():
                        record[key] = float(
                            self.score(extra_data)[0]["mean_IoU"])
                    if summary_file is not None:
                        summary_file.write(json.dumps(record) + "\n")
                        summary_file.flush()
                    if event_writer is not None:
                        event_writer.add_scalars(
                            self.global_step,
                            {k: v for k, v in record.items()
                             if k not in ("step", "wall_time")})
                    if ("abort_at_iou" in self.config and score["mean_IoU"]
                            > self.config["abort_at_iou"]):
                        break
        finally:
            batches.close()
            if summary_file is not None:
                summary_file.close()
            if event_writer is not None:
                event_writer.close()
        print("INFO: Training finished.")

    # --------------------------------------------------------------- predict
    def predict(self, data, output_attr=None):
        """Per-pixel outputs for the input data (``output_attr`` picks a
        test output other than 'prediction'; a name that is no test output
        but an attribute of the model gives that attribute per batch, as
        in the JAX package)."""
        attr = output_attr or "prediction"
        outputs = []
        for batch, valid in iterate_batches(data, self.config["batchsize"]):
            batch = self._batch_to_device(batch)
            if self._parallel is not None:
                batch = self._parallel.shard(batch)
            out = self._forward(batch)
            if attr in out:
                value = out[attr]
                if self._parallel is not None:
                    value = self._parallel.gather(value)
            elif hasattr(self, attr):
                value = getattr(self, attr)
            else:
                raise AttributeError(
                    f"unknown output_attr '{attr}'; this model produces "
                    f"{sorted(out)}")
            outputs.append(to_numpy(value)[:valid])
        return np.concatenate(outputs)

    # ----------------------------------------------------------------- score
    def score(self, data, max_iterations=None):
        """Confusion-matrix metric suite. Returns (measures, confusion).

        Batches come padded from a producer thread that copies them to the
        device ahead of the step (``prefetch_eval_batches``). Each batch's
        counts go into one [K, K] int64 accumulator on the device, one
        kernel launch a batch (``confusion_accumulate``; distributed, of
        this rank's block, and the ranks' totals are then summed); the
        total is read back once and cast to float32 on the host. That
        equals the JAX package's float32 running sum wherever every bin
        is under 2**24; above it, JAX's sum rounds and this one stays
        exact."""
        num_classes = self.config["num_classes"]
        count = 0
        batches = prefetch_eval_batches(data, self.config["batchsize"],
                                        self.device)
        try:
            with torch.inference_mode():
                total = torch.zeros((num_classes, num_classes),
                                    dtype=torch.int64, device=self.device)
                for batch, _ in batches:
                    if self._parallel is not None:
                        batch = self._parallel.shard(batch)
                    out = self._forward(batch)
                    metrics_lib.confusion_accumulate(
                        out["prediction"], batch["labels"], num_classes,
                        total)
                    count += 1
                    if (max_iterations is not None
                            and count >= max_iterations):
                        break
                if self._parallel is not None:
                    # each rank counted its block (kernel A); the sum
                    self._parallel.sum_(total)
        finally:
            batches.close()
        confusion = total.cpu().numpy().astype(np.float32)
        measures = metrics_lib.measures_from_confusion_matrix(confusion)
        return measures, confusion

    # ---------------------------------------------------------- quantization
    def quantize_for_serving(self, data, num_batches=8, min_channels=128,
                             percentile=100.0, min_pixels=None):
        """Enable int8 post-training-quantized inference
        (``models/quantize.py``).

        Calibrates per-conv activation scales on ``num_batches`` batches
        of ``data`` (the measure set), then switches the eligible convs
        (>= ``min_channels`` input channels and >= ``min_pixels`` input
        positions) to the int8 path for every later ``predict``,
        ``score`` and newly started server. ``min_pixels=None`` takes the
        family's ``ptq_min_pixels``. To re-enable without calibrating,
        pass a scales dict this method returned AS ``data``. Returns the
        scales dict (empty, with a warning, when no conv qualifies:
        serving then stays float).
        """
        from modular_semantic_segmentation_torch.models import quantize as q
        if min_pixels is None:
            min_pixels = self.ptq_min_pixels
        if isinstance(data, dict) and all(
                isinstance(v, float) for v in data.values()):
            scales = data
        else:
            amax = q.calibrate_amax(self, data, num_batches=num_batches,
                                    percentile=percentile)
            # stem convs are judged at the packed width only for classes
            # whose _test_outputs packs; select_scales mirrors the
            # remaining batch-shape gates
            prefixes = self.config.get("prefixes")
            packed_prefixes = (
                list(prefixes.values())
                if self.packs_expert_stems
                and isinstance(prefixes, dict) and len(prefixes) >= 2
                and self.config.get("expert_model") == "fcn"
                and self.config.get("pack_experts", True) else None)
            scales = q.select_scales(amax, self.variables,
                                     min_channels=min_channels,
                                     min_pixels=min_pixels,
                                     packed_stem_prefixes=packed_prefixes)
        if not scales:
            print("WARNING: quantize_for_serving found no eligible conv "
                  f"(>= {min_channels} input channels and >= {min_pixels} "
                  "input positions) — serving stays float.")
        self.act_scales = scales or None
        return scales

    def dequantize_serving(self):
        """Return to the float serving path."""
        self.act_scales = None

    # ------------------------------------------------------------- weight IO
    def export_weights(self, save_dir=None):
        out_dir = save_dir or self.output_dir
        if out_dir is None:
            print("ERROR: No path specified to save weights to.")
            return None
        store = dict(self.variables)
        store["global_step"] = np.asarray(self.global_step)
        return params_lib.export_weights(store, out_dir, self.name,
                                         self.global_step)

    def import_weights(self, filepath, translate_prefix=False,
                       chill_mode=False, warnings=True):
        self.variables, report = params_lib.import_weights(
            self.variables, filepath, translate_prefix=translate_prefix,
            chill_mode=chill_mode, warnings=warnings)
        return report

    def load_weights(self, filepath):
        """Restore a checkpoint: an ``.npz`` goes to ``import_weights``;
        a ``checkpoint.pkl`` (this package's or the JAX package's; a path,
        or a file object such as a zip record's artifact) sets the
        variables, the step and, where both have one, the optimizer
        state."""
        if hasattr(filepath, "read"):
            state = pickle.load(filepath)
        elif filepath.endswith(".npz"):
            self.import_weights(filepath, warnings=False)
            return
        else:
            with open(filepath, "rb") as f:
                state = pickle.load(f)
        self.variables = {
            k: torch.from_numpy(np.array(v, np.float32)).to(self.device)
            for k, v in state["variables"].items()}
        self.global_step = int(state.get("global_step", 0))
        if state.get("opt_state") is not None and self.opt_state is not None:
            names = [k for k, train in self.trainable.items() if train]
            self.opt_state = optimizers.state_from_leaves(
                self._optimizer, state["opt_state"], names, self.device)

    def save_checkpoint(self, filepath):
        """Write a checkpoint with the optimizer state, in the JAX
        package's layout: a pickle of ``{"variables": {name: float32
        array}, "global_step": int, "opt_state": [arrays in optax's leaf
        order] or None}``."""
        state = {
            "variables": {k: to_numpy(v) for k, v in self.variables.items()},
            "global_step": self.global_step,
            "opt_state": None if self.opt_state is None else [
                to_numpy(x) for x in optimizers.state_leaves(
                    self._optimizer, self.opt_state)],
        }
        with open(filepath, "wb") as f:
            pickle.dump(state, f)
        return filepath

    # ----------------------------------------------------------- API parity
    def close(self):
        """Nothing to release; kept for the JAX package's API (its CLIs
        build every model in a ``with`` block)."""
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
