"""Spatial partitioning with halo exchange, the sequence-parallel
analogue for CNNs (counterpart of the JAX package's
``parallel/spatial.py``).

A frame's height is split over a mesh axis. A 3x3 SAME conv then needs
the neighbouring blocks' boundary rows: each rank exchanges row halos with
its neighbours (point to point), runs the height VALID on its haloed
block, and the result equals the unsharded SAME conv. ``ops/layers.py``
does this in every conv and deconv of a context with ``spatial_axis``.
"""

import torch
import torch.nn.functional as F

from modular_semantic_segmentation_torch.parallel import collectives
# halo_exchange_rows: the JAX package's name in this module
from modular_semantic_segmentation_torch.parallel.collectives import \
    halo_exchange_rows  # noqa: F401
from modular_semantic_segmentation_torch.parallel.mesh import (
    spatial_sharded)

#: a height block must hold whole 16-row cells, so that the pooling
#: windows of the networks never straddle two blocks (the reference's
#: crop_multiple=16)
ROW_CELL = 16


def _check_height(height, size):
    if height % (size * ROW_CELL):
        raise ValueError(
            f"height {height} not divisible by {size} shards * {ROW_CELL}")


def sharded_conv2d_3x3(x, kernel, mesh, axis="data"):
    """SAME 3x3 conv with the height split over ``axis``.

    Args:
        x: [N, H, W, C_in] global tensor (every rank's block is cut out
            of it here).
        kernel: [3, 3, C_in, C_out].
    Returns:
        [N, H, W, C_out], the unsharded SAME conv, gathered on every
        rank.
    """
    sharding = spatial_sharded(mesh, axis)
    block = sharding.local(x)
    top, bottom = halo_exchange_rows(block, mesh.axis(axis))
    haloed = torch.cat([top, block, bottom], dim=1)
    out = F.conv2d(haloed.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   padding=(0, 1)).permute(0, 2, 3, 1)
    return sharding.gather(out)


def _gather_tree(value, sharding):
    if isinstance(value, dict):
        return {k: _gather_tree(v, sharding) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_gather_tree(v, sharding) for v in value)
    return sharding.gather(value) if value.dim() >= 3 else value


def spatial_sharded_forward(net_fn, variables, x, mesh, axis="data"):
    """Run a WHOLE network forward with the height split over ``axis``.

    ``net_fn(ctx, x)`` is any network built from ``ops/layers``
    (e.g. ``models.simple_fcn.fcn`` in a lambda). Every conv exchanges
    halos of its dilated reach and every deconv one row, which it trims
    after (``ops/layers.py``), so the result equals the unsharded
    forward. Eval mode (the context is not in training mode).

    Args:
        net_fn: callable (ctx, x_block) -> tensor or dict / list of
            tensors, each [N, H_block*, W*, C].
        variables: flat variable dict (whole on every rank).
        x: [N, H, W, C] global input; H must be divisible by (the axis
            size) * 16.
    Returns the outputs gathered to the global height on every rank.
    """
    from modular_semantic_segmentation_torch.ops.variables import Ctx
    spatial = mesh.axis(axis)
    _check_height(x.shape[1], spatial.size)
    sharding = spatial_sharded(mesh, axis)
    with torch.inference_mode():
        ctx = Ctx(variables, spatial_axis=spatial)
        return _gather_tree(net_fn(ctx, sharding.local(x)), sharding)


class SpatialParallel:
    """What ``distribute_spatial`` installs as an Estimator's
    ``_parallel``: every input of three or more dimensions split along
    its height over ``axis``."""

    def __init__(self, mesh, axis):
        self.axis = mesh.axis(axis)
        self.rows = spatial_sharded(mesh, axis)
        self.ctx_kwargs = {"spatial_axis": self.axis}

    def shard(self, batch):
        height = int(batch[next(iter(batch))].shape[1])
        _check_height(height, self.axis.size)
        return {k: self.rows.local(v) if v.dim() >= 3 else v
                for k, v in batch.items()}

    def gather(self, value):
        return self.rows.gather(value) if value.dim() >= 3 else value

    def reduce_grads(self, grads):
        names = list(grads)
        return dict(zip(names, collectives.mean_(
            [grads[k] for k in names], self.axis)))

    def sum_(self, tensor):
        return collectives.all_reduce_(tensor, self.axis)


def distribute_spatial(net, mesh, axis="sp"):
    """Run an Estimator's ``fit`` / ``predict`` / ``score`` with every
    frame split along its height over ``axis`` of ``mesh``: for frames
    too large for one card. Each rank runs its block: row halos for convs
    and deconvs, batch norm's statistics and the void-masked loss summed
    over the axis (sync batch norm), gradients averaged over it (every
    rank then applies the same update, keeping the variables replicated),
    and the confusion counts summed at eval. Equals the unsharded model up
    to float32 reduction order.

    Constraints: frame height divisible by (the axis size) * 16;
    ``device_augmentation`` and ``microbatch_size`` raise; convs stay off
    the int8 path. Returns the estimator."""
    from modular_semantic_segmentation_torch.parallel.data_parallel import \
        _check_device
    _check_device(net, mesh)
    net._parallel = SpatialParallel(mesh, axis)
    return net
