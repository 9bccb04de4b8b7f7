"""Data-parallel training and eval over a mesh (counterpart of the JAX
package's ``parallel/data_parallel.py``).

Variables and optimizer state are replicated; each rank takes its block of
every global batch along the 'data' axis. The JAX package gets the
gradient all-reduce from XLA, which differentiates the global step; here
each rank runs the step on its block with batch norm's statistics and the
masked loss's numerator and label count summed over the axis (the global
batch's, as JAX's global step has them), so each rank's contribution to
the gradient is weighted by its non-void pixels, and the gradients are
averaged over the axis before the (identical) optimizer update.
"""

from modular_semantic_segmentation_torch.parallel import collectives
from modular_semantic_segmentation_torch.parallel.mesh import Sharding


class DataParallel:
    """What ``distribute`` installs as an Estimator's ``_parallel``: the
    batch split along ``data_axis`` (a name, or a tuple of names such as a
    multislice mesh's ``('slice', 'data')``)."""

    def __init__(self, mesh, data_axis="data"):
        self.mesh = mesh
        self.axis = mesh.axis(data_axis)
        self.batch = Sharding(mesh, (data_axis,))
        self.ctx_kwargs = {"data_axis": self.axis}

    def shard(self, batch):
        """This rank's block of a global batch dict (tensors on the
        device)."""
        return {k: self.batch.local(v) for k, v in batch.items()}

    def gather(self, value):
        """The global output from every rank's block."""
        return self.batch.gather(value)

    def reduce_grads(self, grads):
        """The mean of the gradients over the axis (hierarchical over a
        multislice axis)."""
        names = list(grads)
        return dict(zip(names, collectives.mean_(
            [grads[k] for k in names], self.axis)))

    def sum_(self, tensor):
        """Sum a no-gradient tensor (counts) over the axis, in place."""
        return collectives.all_reduce_(tensor, self.axis)


def _check_device(estimator, mesh):
    if estimator.device.type != mesh.device.type:
        raise ValueError(f"the model lives on {estimator.device}, the mesh "
                         f"computes on {mesh.device}")


def distribute(estimator, mesh, data_axis="data"):
    """Run an Estimator's ``fit`` / ``predict`` / ``score`` data-parallel
    over ``mesh``: each rank takes its block of every batch along
    ``data_axis``. The global batch size must be divisible by the axis
    size. Every rank calls it on a model built alike (same seed). Returns
    the estimator (for chaining)."""
    _check_device(estimator, mesh)
    estimator._parallel = DataParallel(mesh, data_axis)
    return estimator
