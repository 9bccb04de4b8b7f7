"""Averaging fusion (counterpart of the JAX package's
``models/average_fusion.py``; reference xview/models/average_mix.py)."""

import torch

from modular_semantic_segmentation_torch.models.fusion_base import FusionModel


class AverageFusion(FusionModel):
    """Mixture of CNN experts by averaging their probability vectors."""

    def __init__(self, output_dir=None, **config):
        FusionModel.__init__(self, name="AverageFusion",
                             output_dir=output_dir, **config)

    def _fusion(self, expert_outputs):
        average_prob = torch.mean(
            torch.stack([expert_outputs[m]["prob"] for m in self.modalities]),
            dim=0)
        return {"prediction": average_prob.argmax(-1).to(torch.int32),
                "fused_score": average_prob}
