"""Dirichlet fusion, inference (counterpart of the JAX package's
``models/dirichlet_fusion.py``).

Per (expert, class) a Dirichlet distribution over the expert's softmax
simplex. The fitted parameters are passed in (``dirichlet_params`` with
``class_counts``); fitting them by EM on a measure set is not ported yet.
With ``use_pallas`` the fused label comes from the one-pass kernel of
``ops/cuda/dirichlet.py`` (the name of the JAX option is kept); otherwise
from the plain ``ops/fusion_math.dirichlet_fusion``.
"""

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.ops.cuda import dirichlet
from modular_semantic_segmentation_torch.models.fusion_base import FusionModel


class DirichletFusion(FusionModel):
    """Mixture of CNN experts following the 'dirichlet mix' method.

    Args:
        prefixes: dict {modality: prefix} of the experts (or
            ``modalities``, with prefix == modality name).
        sigma: Dirichlet temperature.
        class_prior: 'data' | 'uniform' | float.
        dirichlet_params: {modality: [K, C] concentrations,
            'class_counts': [C]}. Without it the model is in its
            measurement phase and predicts zeros.
        use_pallas: fuse with the one-pass kernel.
    """

    def __init__(self, output_dir=None, **config):
        standard_config = {"sigma": 1.0, "class_prior": "data"}
        standard_config.update(config)
        if "prefixes" not in standard_config:
            standard_config["prefixes"] = {
                m: m for m in standard_config.pop("modalities")}
        if "measurement_exp" in config:
            raise NotImplementedError(
                "measurement_exp needs the experiment store, which is not "
                "ported yet; pass dirichlet_params")
        measurements = standard_config.pop("dirichlet_params", None)

        modalities = list(standard_config["prefixes"].keys())
        if measurements is not None:
            self.dirichlet_params = {
                m: np.asarray(measurements[m], "float32")
                for m in modalities}
            self.class_counts = np.asarray(measurements["class_counts"],
                                           "float32")
        else:
            self.dirichlet_params = None
            self.class_counts = None
            print("WARNING: Could not yet import measurements, you need to "
                  "fit this model first.")
        self._tables = {}
        FusionModel.__init__(self, name="DirichletFusion",
                             output_dir=output_dir, **standard_config)

    def _prior(self):
        data_prior = self.class_counts / (1e-20 + self.class_counts.sum())
        return fm.class_prior(self.config["class_prior"], data_prior)

    def _kernel_tables(self, device, num_classes):
        """(coeffs, bias) of the kernel on ``device``, built on first use."""
        key = str(device)
        if key not in self._tables:
            coeffs, bias = dirichlet.dirichlet_tables(
                [self.dirichlet_params[m] for m in self.modalities],
                self._prior(), self.config["sigma"], num_classes)
            self._tables[key] = (torch.from_numpy(coeffs).to(device),
                                 torch.from_numpy(bias).to(device))
        return self._tables[key]

    def _fusion(self, expert_outputs):
        # normalize probs defensively, as the reference does
        probs = {m: expert_outputs[m]["prob"] /
                 torch.sum(expert_outputs[m]["prob"], dim=3, keepdim=True)
                 for m in self.modalities}
        out = {f"{m}_norm_prob": probs[m] for m in self.modalities}
        if self.dirichlet_params is None:
            # measurement phase: no fusion defined yet
            cls = expert_outputs[self.modalities[0]]["classification"]
            out["prediction"] = torch.zeros(cls.shape, dtype=torch.int32,
                                            device=cls.device)
            out["fused_score"] = torch.zeros(
                tuple(cls.shape) + (self.config["num_classes"],),
                dtype=torch.float32, device=cls.device)
            return out
        if self.config.get("use_pallas"):
            first = probs[self.modalities[0]]
            k = first.shape[-1]
            stacked = torch.stack([probs[m].reshape(-1, k)
                                   for m in self.modalities])
            coeffs, bias = self._kernel_tables(first.device, k)
            out["prediction"] = dirichlet.dirichlet_label(
                stacked, coeffs, bias).reshape(first.shape[:-1])
            return out
        fused = fm.dirichlet_fusion(
            [probs[m] for m in self.modalities],
            [self.dirichlet_params[m] for m in self.modalities],
            self._prior(), sigma=self.config["sigma"])
        out["prediction"] = torch.argmax(fused, 3)
        out["fused_score"] = fused
        return out
