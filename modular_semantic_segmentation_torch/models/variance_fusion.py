"""MC-dropout variance-weighted fusion (counterpart of the JAX package's
``models/variance_fusion.py``; reference xview/models/variance_mix.py and
experiments/timing.py:180-233).

Each expert runs N stochastic forward passes with dropout after pool3 (and,
by the reference's quirk, after pool4); the per-pixel sample variance
weights the clean expert probabilities by inverse variance. Every dropout
site lies after pool3, so conv1..pool3 runs once per expert, and the N
stochastic tails run as one tail at batch N*B: the tail's convs and pools
treat each batch element alone and dropout draws a mask per element, so
the batched pass computes sample for sample what an N-loop would.

The JAX model builds its experts at full width whatever
``channel_factor`` says; the port honours ``channel_factor`` here as in
every other fusion model (at 1.0, the default, the two agree). The
deterministic heads take the packed stems (``models/packed_experts.py``)
like every FCN fusion.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.models.fusion_base import FusionModel
from modular_semantic_segmentation_torch.models.packed_experts import (
    can_pack_stems, packed_fcn_stems)
from modular_semantic_segmentation_torch.models.simple_fcn import (
    decoder, encoder_head, encoder_tail)


class VarianceFusion(FusionModel):
    """Config: prefixes (or modalities), num_units, dropout_rate,
    num_samples; expert_model must be 'fcn' (reference
    variance_mix.py:51). The experts run without batch norm."""

    def __init__(self, output_dir=None, **config):
        standard_config = {"num_samples": 10}
        standard_config.update(config)
        if "prefixes" not in standard_config:
            standard_config["prefixes"] = {
                m: m for m in standard_config.pop("modalities")}
        if standard_config.get("expert_model", "fcn") != "fcn":
            raise ValueError("VarianceFusion takes FCN experts only")
        standard_config["expert_model"] = "fcn"
        FusionModel.__init__(self, name="VarianceFusion",
                             output_dir=output_dir, **standard_config)

    def _eager_serving_reason(self):
        if self.config["dropout_rate"] > 0 and self.config["num_samples"] > 1:
            return "MC dropout draws from the model's generator every frame"
        return None

    def _tail_prob(self, ctx, pool3, prefix, dropout):
        """pool3 -> class probabilities; stochastic iff ``dropout``."""
        cfg = self.config
        l = encoder_tail(
            ctx, {"pool3": pool3}, prefix, cfg["num_units"],
            batchnorm=False, channel_factor=cfg.get("channel_factor", 1.0),
            dropout_rate=cfg["dropout_rate"] if dropout else 0.0,
            dropout_layers=("pool3",) if dropout else ())
        dec = decoder(ctx, l["fused"], prefix, cfg["num_units"],
                      cfg["num_classes"], batchnorm=False)
        return ll.softmax(dec["score"])

    def _test_outputs(self, ctx, batch):
        probs, variances = {}, {}
        num_samples = self.config["num_samples"]
        channel_factor = self.config.get("channel_factor", 1.0)
        stems = {}
        if can_pack_stems(ctx, batch, self.modalities, self.config):
            stems = packed_fcn_stems(ctx, batch, self.modalities,
                                     self.config["prefixes"],
                                     channel_factor=channel_factor)
        for m in self.modalities:
            prefix = self.config["prefixes"][m]
            head = encoder_head(ctx, batch[m], prefix, batchnorm=False,
                                channel_factor=channel_factor,
                                stem_layers=stems.get(m))
            # the classification probabilities come from a clean pass
            probs[m] = self._tail_prob(ctx, head["pool3"], prefix,
                                       dropout=False)
            if self.config["dropout_rate"] == 0 or num_samples < 2:
                # At dropout 0 (or a single sample) every stochastic pass
                # is the clean pass and the sample variance is exactly
                # zero. A batched tail would measure the convolutions'
                # rounding by batch position instead, which 1/(1e-20 +
                # var) amplifies into arbitrary expert selection.
                variances[m] = torch.zeros(
                    probs[m].shape[:-1] + (1,), dtype=probs[m].dtype,
                    device=probs[m].device)
                continue
            stacked = self._tail_prob(
                ctx, head["pool3"].repeat(num_samples, 1, 1, 1), prefix,
                dropout=True)
            samples = stacked.reshape(
                (num_samples, stacked.shape[0] // num_samples)
                + stacked.shape[1:])
            variances[m] = torch.var(samples, dim=0, correction=0).mean(
                dim=3, keepdim=True)

        fused = fm.variance_fusion(
            torch.stack([probs[m] for m in self.modalities]),
            torch.stack([variances[m] for m in self.modalities]))
        out = {"prediction": torch.argmax(fused, 3).to(torch.int32),
               "fused_score": fused}
        for m in self.modalities:
            out[f"{m}_prob"] = probs[m] / torch.sum(probs[m], dim=3,
                                                    keepdim=True)
            out[f"{m}_variance"] = variances[m]
        return out
