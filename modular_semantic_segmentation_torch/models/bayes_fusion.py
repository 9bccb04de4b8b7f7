"""Bayes fusion of expert classifications via confusion-matrix likelihoods
(counterpart of the JAX package's ``models/bayes_fusion.py``).

The per-expert tables (conditionals, their logs, the log prior) are built
once per device and kept, where the JAX package bakes them into the jitted
step as constants. ``use_decision_matrix`` replaces the fusion by one K^E
table lookup.
"""

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.models.fusion_base import FusionModel


class BayesFusion(FusionModel):
    """Mixture of CNN experts following the 'bayes mix' method.

    Args:
        confusion_matrices: dict {modality: [K, K] matrix} measured on the
            measure set (rows = true class, as ``score`` returns them).
            Alternatively ``eval_experiments`` maps modalities to the ids
            of past evaluation runs (of either package), whose stored
            ``confusion_matrix`` is loaded.
        class_prior: 'data' | 'uniform' | float mixture weight.
    """

    def __init__(self, output_dir=None, confusion_matrices=False, **config):
        standard_config = {"class_prior": "data"}
        standard_config.update(config)
        if not confusion_matrices:
            from modular_semantic_segmentation_torch.utils.experiment import \
                ExperimentData
            confusion_matrices = {}
            for key, exp_id in config["eval_experiments"].items():
                stored = ExperimentData(exp_id).get_record()["info"][
                    "confusion_matrix"]
                if isinstance(stored, dict):  # un-decoded record form
                    stored = stored["values"]
                confusion_matrices[key] = stored
        # transposed, as the reference model does
        self.confusion_matrices = {
            key: np.asarray(matrix).astype("float32").T
            for key, matrix in confusion_matrices.items()}
        self._tables = {}
        FusionModel.__init__(self, name="BayesFusion", output_dir=output_dir,
                             **standard_config)

    def _device_tables(self, device):
        """Fusion tables on ``device``, built on first use; those a traced
        program builds (``serving.export_serving``) stay in the program."""
        key = str(device)
        tables = (dict(self._tables) if torch.compiler.is_compiling()
                  else self._tables)
        if key not in tables:
            matrices = [self.confusion_matrices[m] for m in self.modalities]
            if self.config.get("use_decision_matrix"):
                tables[key] = torch.from_numpy(
                    fm.bayes_decision_matrix(
                        matrices, self.config["class_prior"])).to(device)
            else:
                tables[key] = fm.bayes_tables(
                    matrices, self.config["class_prior"], device=device)
        return tables[key]

    def _fusion(self, expert_outputs):
        classifications = [expert_outputs[m]["classification"]
                           for m in self.modalities]
        tables = self._device_tables(classifications[0].device)
        if self.config.get("use_decision_matrix"):
            return {"prediction": fm.apply_decision_matrix(tables,
                                                           classifications)}
        fused_score, likelihoods, conditionals = fm.bayes_fusion_from_tables(
            classifications, tables)
        out = {"prediction": torch.argmax(fused_score, 3).to(torch.int32),
               "fused_score": fused_score}
        for m, ll_, cond in zip(self.modalities, likelihoods, conditionals):
            out[f"{m}_likelihood"] = ll_
            out[f"{m}_conditional"] = cond
        return out

    def get_insight(self, data):
        """Per-pixel fusion diagnostics: (probs, likelihoods, conditionals,
        prediction), lists in modality order."""
        probs = [self.predict(data, output_attr=f"{m}_prob")
                 for m in self.modalities]
        likelihoods = [self.predict(data, output_attr=f"{m}_likelihood")
                       for m in self.modalities]
        conditionals = [self.predict(data, output_attr=f"{m}_conditional")
                        for m in self.modalities]
        return probs, likelihoods, conditionals, self.predict(data)
