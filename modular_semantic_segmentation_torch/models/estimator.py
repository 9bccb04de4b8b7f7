"""Estimator: the eval runtime shared by every model of the port.

Counterpart of the JAX package's ``models/estimator.py``, eval subset:
config handling and ``compute_dtype``, ``_preprocess`` (``input_scaling``
and integer promotion), the eval step, ``predict``, ``score`` (partial
batches padded with label -1), int8 post-training-quantized serving
(``quantize_for_serving`` / ``dequantize_serving``) and npz
``import_weights`` / ``export_weights``. Training is not ported yet.

Variables are a flat ``{tf_name: float32 tensor}`` store on ``device``,
made from the subclass's variable specs and a numpy seed (config ``seed``,
default 0). The same seed starts the model's ``torch.Generator`` on
``device``, the random stream of its stochastic layers (MC dropout); it
advances with every draw, as the JAX package's key is split per step.
PyTorch runs eagerly, so there is no jitted step: the eval step is a
plain call under ``torch.inference_mode``.

Subclass contract:
    _variable_specs() -> [(name, shape, initializer), ...]
    _test_outputs(ctx, batch) -> dict with 'prediction' (+ 'prob', ...)
"""

import numpy as np
import torch

from modular_semantic_segmentation_torch.models import params as params_lib
from modular_semantic_segmentation_torch.ops import metrics as metrics_lib
from modular_semantic_segmentation_torch.ops.init import build_variables
from modular_semantic_segmentation_torch.ops.layers import configure_float32
from modular_semantic_segmentation_torch.ops.variables import (
    Ctx, resolve_device, resolve_dtype)
from modular_semantic_segmentation_torch.utils.data_io import iterate_batches


def to_numpy(value):
    """Host numpy copy of a tensor; bfloat16 comes back as float32, which
    numpy has no type for."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    value = value.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.cpu().numpy()


class Estimator:
    """Base class for all models. See module docstring.

    Args:
        data_description: (dtypes, shapes, num_classes), as a dataset's
            ``get_data_description()`` gives it.
        compute_dtype: 'float32' | 'bfloat16', the dtype inside the convs.
        device: where variables live and the model runs; 'cuda' (the
            default) raises when there is no card.
    """

    #: whether ``_test_outputs`` runs FCN expert stems through
    #: ``models/packed_experts.py`` where it applies; quantize_for_serving
    #: judges stem convs at the packed width only for such classes
    packs_expert_stems = False

    #: default ``min_pixels`` of quantize_for_serving, the JAX package's:
    #: 2048 (its AdapNet floor); the VGG/FCN family overrides it to 0
    ptq_min_pixels = 2048

    def __init__(self, data_description, name=None, output_dir=None,
                 batchsize=1, compute_dtype="float32", device="cuda",
                 **config):
        self.name = name if name is not None else type(self).__name__
        self.output_dir = output_dir
        self.config = config
        self.config["batchsize"] = batchsize
        self.config["num_classes"] = data_description[2]
        self.data_description = data_description
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.global_step = 0
        self._kernel_cache = {}
        # int8 PTQ serving: None = float path; set by quantize_for_serving
        self.act_scales = None
        configure_float32()
        seed = int(config.get("seed", 0))
        self.variables = build_variables(self._variable_specs(), seed=seed,
                                         device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    # ------------------------------------------------------------- contracts
    def _variable_specs(self):
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
                      generator=self._generator, act_scales=act_scales)
            return self._test_outputs(ctx, self._preprocess(batch))

    def _eval_step(self, batch):
        """Test outputs and, with labels in the batch, its confusion
        matrix."""
        out = self._forward(batch)
        if "labels" in batch:
            with torch.inference_mode():
                out["confusion_matrix"] = metrics_lib.confusion_matrix(
                    out["prediction"], batch["labels"],
                    self.config["num_classes"])
        return out

    # --------------------------------------------------------------- predict
    def predict(self, data, output_attr=None):
        """Per-pixel outputs for the input data (``output_attr`` picks a
        test output other than 'prediction')."""
        attr = output_attr or "prediction"
        outputs = []
        for batch, valid in iterate_batches(data, self.config["batchsize"]):
            out = self._forward(self._batch_to_device(batch))
            if attr not in out:
                raise AttributeError(
                    f"unknown output_attr '{attr}'; this model produces "
                    f"{sorted(out)}")
            outputs.append(to_numpy(out[attr])[:valid])
        return np.concatenate(outputs)

    # ----------------------------------------------------------------- score
    def score(self, data, max_iterations=None):
        """Confusion-matrix metric suite. Returns (measures, confusion).

        Each batch's counts go into one [K, K] int64 accumulator on the
        device, one kernel launch a batch (``confusion_accumulate``); the
        total is read back once and cast to float32 on the host. That
        equals the JAX package's float32 running sum wherever every bin
        is under 2**24; above it, JAX's sum rounds and this one stays
        exact."""
        num_classes = self.config["num_classes"]
        count = 0
        with torch.inference_mode():
            total = torch.zeros((num_classes, num_classes),
                                dtype=torch.int64, device=self.device)
            for batch, _ in iterate_batches(data, self.config["batchsize"]):
                batch = self._batch_to_device(batch)
                out = self._forward(batch)
                metrics_lib.confusion_accumulate(
                    out["prediction"], batch["labels"], num_classes, total)
                count += 1
                if max_iterations is not None and count >= max_iterations:
                    break
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
