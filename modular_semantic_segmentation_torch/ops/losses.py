"""Losses (counterpart of the JAX package's ``ops/losses.py``).

The reference's masked cross-entropy: labels are one-hot with all-zero rows
for void or unlabelled pixels, so those pixels drop out of both the
numerator and the (label-count) denominator.
"""

import torch


def one_hot(labels, num_classes):
    """float32 one-hot of integer labels over a new last axis; a label
    outside [0, num_classes) (void, -1) gives an all-zero row, as
    ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def cross_entropy(log_predictions, onehot_labels, axis_name=None):
    """-sum(labels * log_probs) / (1e-20 + sum(labels)), in float32.

    Args:
        log_predictions: [..., K] log-probabilities.
        onehot_labels: [..., K] one-hot float labels; all-zero rows mask
            the pixel out entirely.
        axis_name: the mesh axis (``parallel.mesh.Axis``), or tuple of
            axes, the pixels are sharded over (``Ctx.sharded_axes``):
            numerator and label count are summed over the shards, so
            every shard computes the GLOBAL masked mean, which the void
            mask keeps from splitting into per-shard means.
    """
    labels = onehot_labels.float()
    pixel_ce = -torch.sum(labels * log_predictions.float(), dim=-1)
    num, den = torch.sum(pixel_ce), torch.sum(labels)
    if axis_name:
        from modular_semantic_segmentation_torch.parallel import collectives
        num = collectives.all_reduce(num, axis_name)
        den = collectives.all_reduce(den, axis_name)
    return num / (1e-20 + den)
