"""BayesianFCN: MC-dropout uncertainty FCN (counterpart of the JAX
package's ``models/bayesian_fcn.py``; reference xview/models/bayesian_fcn.py,
after Kendall's Bayesian SegNet, arXiv 1511.02680).

N stochastic forward passes give the mean probability plus three
uncertainty maps: entropy of the mean, mean conditional entropy, and summed
variance (reference bayesian_fcn.py:9-57). Every dropout site lies after
pool3, so the N samples share one head pass and run the stochastic tail
and decoder as one batch of N*B elements, which computes sample for
sample what an N-loop would. Temperature scaling via config
``temperature_scaling``. Training runs one stochastic pass through every
dropout site, drawing from the model's generator.
"""

import torch

from modular_semantic_segmentation_torch.ops import layers as ll
from modular_semantic_segmentation_torch.ops.losses import cross_entropy
from modular_semantic_segmentation_torch.models.simple_fcn import (
    decoder, encoder_head, encoder_tail, fcn, fcn_variable_specs)
from modular_semantic_segmentation_torch.models.uncertainty_model import \
    UncertaintyModel


def sampling_uncertainty(samples):
    """Mean probability + uncertainty dict from stacked MC samples
    [S, N, H, W, K] (reference bayesian_fcn.py:48-57)."""
    mean = torch.mean(samples, dim=0)
    return mean, {
        "entropy": ll.entropy(mean),
        "cond_entropy": torch.mean(ll.entropy(samples), dim=0),
        "variance": torch.sum(torch.var(samples, dim=0, correction=0),
                              dim=-1),
    }


class BayesianFCN(UncertaintyModel):
    """FCN with MC-dropout sampling uncertainty.

    Config: num_units, dropout_rate (0.5), num_samples (10), method
    ('sampling'), dropout_layers (default pool3/pool4/conv4_3/conv5_3/
    features), batch_normalization (True: eval BN from the imported
    moving statistics), temperature_scaling (optional softmax
    temperature), channel_factor.
    """

    ptq_min_pixels = 0  # VGG16 stack: see SimpleFCN.ptq_min_pixels

    def __init__(self, prefix, data_description, modality, output_dir=None,
                 dropout_layers=("pool3", "pool4", "conv4_3", "conv5_3",
                                 "features"),
                 **config):
        self.prefix = prefix
        self.modality = modality
        standard_config = {"method": "sampling", "num_samples": 10,
                           "dropout_rate": 0.5, "batch_normalization": True}
        standard_config.update(config)
        UncertaintyModel.__init__(self, data_description,
                                  output_dir=output_dir,
                                  dropout_layers=tuple(dropout_layers),
                                  **standard_config)

    def _eager_serving_reason(self):
        if self.config["dropout_rate"] > 0:
            return "MC dropout draws from the model's generator every frame"
        return None

    def _variable_specs(self):
        return fcn_variable_specs(
            self.prefix, self._input_channels(self.modality),
            self.config["num_units"], self.config["num_classes"],
            batchnorm=self.config["batch_normalization"],
            channel_factor=self.config.get("channel_factor", 1.0))

    def _train_outputs(self, ctx, batch):
        cfg = self.config
        layers = fcn(ctx, batch[self.modality], self.prefix,
                     cfg["num_units"], cfg["num_classes"],
                     batchnorm=cfg["batch_normalization"],
                     channel_factor=cfg.get("channel_factor", 1.0),
                     dropout_rate=cfg["dropout_rate"],
                     dropout_layers=cfg["dropout_layers"])
        log_prob = ll.log_softmax(layers["score"])
        return {"loss": cross_entropy(log_prob, batch["labels"],
                                      axis_name=ctx.sharded_axes)}

    def _test_outputs(self, ctx, batch):
        cfg = self.config
        batchnorm = cfg["batch_normalization"]
        channel_factor = cfg.get("channel_factor", 1.0)
        n = cfg["num_samples"]
        head = encoder_head(ctx, batch[self.modality], self.prefix,
                            batchnorm=batchnorm,
                            channel_factor=channel_factor)
        tail = encoder_tail(
            ctx, {"pool3": head["pool3"].repeat(n, 1, 1, 1)}, self.prefix,
            cfg["num_units"], batchnorm=batchnorm,
            channel_factor=channel_factor, dropout_rate=cfg["dropout_rate"],
            dropout_layers=cfg["dropout_layers"])
        dec = decoder(
            ctx, tail["fused"], self.prefix, cfg["num_units"],
            cfg["num_classes"], batchnorm=batchnorm,
            dropout_rate=(cfg["dropout_rate"]
                          if "features" in cfg["dropout_layers"] else None))
        stacked = ll.softmax(dec["score"],
                             temperature=cfg.get("temperature_scaling", 1.0))
        samples = stacked.reshape((n, stacked.shape[0] // n)
                                  + stacked.shape[1:])
        mean, uncertainties = sampling_uncertainty(samples)
        out = {"prob": mean,
               "prediction": torch.argmax(mean, 3).to(torch.int32)}
        out.update(uncertainties)
        return out
