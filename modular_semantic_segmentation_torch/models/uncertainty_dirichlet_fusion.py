"""Dirichlet fusion modulated by per-pixel MC-dropout uncertainty
(counterpart of the JAX package's ``models/uncertainty_dirichlet_fusion.py``;
reference xview/models/uncertainty_dirichlet_mix.py).

Per expert, N stochastic passes with WHOLE-PIXEL input dropout (noise shape
with channel dim 1, reference :120-128) give a per-pixel variance; the
variance normalized by its global maximum blends the fitted Dirichlet
concentrations toward the uninformative I+1 parameters (reference
:18-52). Fitting is inherited from DirichletFusion (same EM). The fused
score comes from ``ops/fusion_math.dirichlet_uncertainty_fusion``: kernel
B does not run here, as in the JAX package.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.models.dirichlet_fusion import \
    DirichletFusion
from modular_semantic_segmentation_torch.models.fusion_base import \
    test_pipeline


class UncertaintyDirichletFusion(DirichletFusion):
    """Config: everything DirichletFusion takes, plus num_samples and
    dropout_rate for the input-level MC dropout."""

    # its per-expert MC-dropout pipelines bypass expert_pipelines: the
    # packed stems never run here
    packs_expert_stems = False

    def __init__(self, output_dir=None, **config):
        standard_config = {"num_samples": 10, "dropout_rate": 0.2}
        standard_config.update(config)
        DirichletFusion.__init__(self, output_dir=output_dir,
                                 **standard_config)

    def _eager_serving_reason(self):
        return ("MC dropout draws from the model's generator every "
                "frame, and the fusion copies its parameters from host "
                "arrays to the device")

    def _test_outputs(self, ctx, batch):
        num_classes = self.config["num_classes"]
        probs, uncertainties = {}, {}
        for m in self.modalities:
            prefix = self.config["prefixes"][m]
            inputs = batch[m]
            n, h, w, _ = inputs.shape
            samples = torch.stack(
                [test_pipeline(ctx, ll.dropout(
                    ctx, inputs, self.config["dropout_rate"],
                    noise_shape=(n, h, w, 1)), prefix, **self.config)["prob"]
                 for _ in range(self.config["num_samples"])], dim=4)
            variance = torch.var(samples, dim=4, correction=0)
            # mix in [0, 1]: per-pixel mean variance over the global max
            # (reference uncertainty_dirichlet_mix.py:28-31)
            mix = torch.mean(variance, dim=3) / (1e-20 + torch.max(variance))
            clean = test_pipeline(ctx, inputs, prefix, **self.config)["prob"]
            probs[m] = clean / torch.sum(clean, dim=3, keepdim=True)
            uncertainties[m] = mix

        if self.dirichlet_params is None:
            shape = next(iter(probs.values())).shape[:-1]
            device = next(iter(probs.values())).device
            return {"prediction": torch.zeros(shape, dtype=torch.int32,
                                              device=device),
                    "fused_score": torch.zeros(
                        tuple(shape) + (num_classes,), dtype=torch.float32,
                        device=device)}
        fused = fm.dirichlet_uncertainty_fusion(
            [probs[m] for m in self.modalities],
            [self.dirichlet_params[m] for m in self.modalities],
            [uncertainties[m] for m in self.modalities],
            self._prior(), sigma=self.config["sigma"])
        out = {"prediction": torch.argmax(fused, 3).to(torch.int32),
               "fused_score": fused}
        for m in self.modalities:
            out[f"{m}_prob"] = probs[m]
            out[f"{m}_uncertainty"] = uncertainties[m]
        return out
