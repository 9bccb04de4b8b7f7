"""Fusion model base: frozen expert networks per modality whose per-pixel
outputs are fused (counterpart of the JAX package's
``models/fusion_base.py``).

The experts, FCN or AdapNet, run one after the other. FCN stems go
through ``models/packed_experts.py`` when it applies (``pack_experts``,
default on), which selects the int8 scales of the packed stem convs.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.models.adapnet import (
    adapnet, adapnet_variable_specs)
from modular_semantic_segmentation_torch.models.estimator import Estimator
from modular_semantic_segmentation_torch.models.packed_experts import (
    can_pack_stems, packed_fcn_stems)
from modular_semantic_segmentation_torch.models.simple_fcn import (
    fcn, fcn_variable_specs)


def test_pipeline(ctx, inputs, prefix, expert_model, num_units, num_classes,
                  batch_normalization=False, channel_factor=1.0,
                  stem_layers=None, **_):
    """Frozen expert network + softmax 'prob' and argmax 'classification'.

    ``batch_normalization`` (FCN experts) defaults to False, like the
    reference's hardcoded ``batchnorm=False``; eval-mode BN uses the
    imported moving statistics when it is on. AdapNet experts always have
    batch norm. ``stem_layers``: the expert's precomputed conv1_1..conv2_1
    layers (``models/packed_experts.py``), FCN only."""
    if expert_model == "adapnet":
        outputs = adapnet(ctx, inputs, prefix, num_units, num_classes)
    elif expert_model == "fcn":
        outputs = fcn(ctx, inputs, prefix, num_units, num_classes,
                      batchnorm=batch_normalization,
                      channel_factor=channel_factor, stem_layers=stem_layers)
    else:
        raise UserWarning(f"ERROR: Expert Model {expert_model} not found")
    outputs["prob"] = ll.softmax(outputs["score"])
    # argmax of the raw score == argmax of its softmax (monotone); int32,
    # as jnp.argmax gives it
    outputs["classification"] = outputs["score"].argmax(-1).to(torch.int32)
    return outputs


def expert_pipelines(ctx, batch, modalities, config):
    """Per-modality expert outputs, ``{modality: test_pipeline(...)}``,
    with the FCN stems through ``packed_fcn_stems`` where it applies."""
    stems = {}
    if can_pack_stems(ctx, batch, modalities, config):
        stems = packed_fcn_stems(
            ctx, batch, modalities, config["prefixes"],
            channel_factor=config.get("channel_factor", 1.0),
            batch_normalization=config.get("batch_normalization", False))
    return {m: test_pipeline(ctx, batch[m], config["prefixes"][m],
                             stem_layers=stems.get(m), **config)
            for m in modalities}


class FusionModel(Estimator):
    """Mixture-of-experts base. Eval only (``custom_training``): ``fit``
    raises UserWarning, as in the JAX package, unless a subclass fits its
    own way (``DirichletFusion.fit``).

    Config:
        prefixes: dict {modality: variable-name prefix} for the experts.
        expert_model: 'fcn' | 'adapnet'.
        pack_experts: run the FCN stems through ``packed_fcn_stems``
            (default True).
    """

    # _test_outputs -> expert_pipelines takes the packed stems when they
    # apply, so quantize_for_serving judges the stem convs at the packed
    # width
    packs_expert_stems = True

    @property
    def ptq_min_pixels(self):
        """int8 spatial floor by expert family, as in the JAX package: 0
        for FCN experts, 2048 otherwise."""
        return 0 if self.config.get("expert_model") == "fcn" else 2048

    def __init__(self, name=None, output_dir=None, **config):
        self.modalities = list(config["prefixes"].keys())
        Estimator.__init__(self, data_description=config.pop(
            "data_description"), name=name, output_dir=output_dir,
            custom_training=True, **config)

    def _variable_specs(self):
        expert_model = self.config.get("expert_model")
        if expert_model not in ("fcn", "adapnet"):
            raise UserWarning(f"ERROR: Expert Model {expert_model} not found")
        specs = []
        for m in self.modalities:
            args = (self.config["prefixes"][m], self._input_channels(m),
                    self.config["num_units"], self.config["num_classes"])
            if expert_model == "adapnet":
                specs += adapnet_variable_specs(*args)
            else:
                specs += fcn_variable_specs(
                    *args,
                    batchnorm=self.config.get("batch_normalization", False),
                    channel_factor=self.config.get("channel_factor", 1.0))
        return specs

    def _fusion(self, expert_outputs):
        """Fuse expert outputs into a dict with at least 'prediction'."""
        raise NotImplementedError

    def _test_outputs(self, ctx, batch):
        expert_outputs = expert_pipelines(ctx, batch, self.modalities,
                                          self.config)
        out = self._fusion(expert_outputs)
        # per-expert diagnostics for predict(output_attr=...)
        for m in self.modalities:
            out[f"{m}_prob"] = expert_outputs[m]["prob"]
            out[f"{m}_classification"] = expert_outputs[m]["classification"]
        return out

    def import_expert_weights(self, weight_files, **kwargs):
        """Import per-expert npz files: {modality: filepath} (each with its
        prefix translated) or a single path for all."""
        if isinstance(weight_files, str):
            return self.import_weights(weight_files, **kwargs)
        reports = {}
        for modality, filepath in weight_files.items():
            reports[modality] = self.import_weights(
                filepath, translate_prefix=self.config["prefixes"][modality],
                **kwargs)
        return reports
