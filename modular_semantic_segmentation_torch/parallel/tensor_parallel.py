"""Tensor (model) parallelism: channel-sharded variables over a mesh axis
(counterpart of the JAX package's ``parallel/tensor_parallel.py``).

Each rank of the 'model' axis stores only its channel shard of a variable
that :func:`channel_sharding` splits: a 4-D kernel along its last
dimension (a conv's output channels; a deconv's [kh, kw, out, in] input
channels), a per-channel vector along its only one; anything else whole.
Optimizer slots follow their variables. The JAX package commits the
shards to devices and GSPMD inserts the collectives; here they are written
out (``ops/layers.py`` with ``Ctx.tensor_parallel``): a conv whose kernel
is sharded computes its shard of the output channels from the whole
input, adds its bias shard, runs batch norm and the activation on those
channels, and gathers the channels, since the next op needs all of them.
A deconv gathers its kernel's input-channel shards and runs whole (the
frozen bilinear upsampling kernels are small).

Composes with data parallelism on a 2-D ``('data', 'model')`` mesh: the
batch splits over 'data' (variables replicated along it), channels over
'model' (the batch replicated along it).
"""

from modular_semantic_segmentation_torch.parallel import collectives
from modular_semantic_segmentation_torch.parallel.data_parallel import (
    DataParallel, _check_device)
from modular_semantic_segmentation_torch.parallel.mesh import Sharding


def channel_sharding(mesh, shape, axis="model"):
    """The :class:`~.mesh.Sharding` of one variable of global ``shape``:
    a 4-D kernel's last dimension over ``axis`` when the axis size divides
    it, a 1-D vector's when the size divides it and the vector is longer
    than the size; else replicated."""
    size = mesh.shape[axis]
    shape = tuple(int(s) for s in shape)
    if size > 1:
        if len(shape) == 4 and shape[3] % size == 0:
            return Sharding(mesh, (None, None, None, axis))
        if len(shape) == 1 and shape[0] % size == 0 and shape[0] > size:
            return Sharding(mesh, (axis,))
    return Sharding(mesh, ())


def tp_shardings(mesh, variables, axis="model"):
    """Per-variable channel shardings for a flat variable dict."""
    return {name: channel_sharding(mesh, value.shape, axis)
            for name, value in variables.items()}


class ChannelShards:
    """A context's view of the channel shards (``Ctx.tensor_parallel``):
    which variables are stored as shards, and the channel collectives of
    the model axis."""

    def __init__(self, axis, shardings):
        self.axis = axis
        self._sharded = {name for name, s in shardings.items()
                         if not s.is_fully_replicated}

    def is_sharded(self, name):
        return name in self._sharded

    def enter(self, x):
        """The whole input ``x`` of an op that computes this rank's
        output channels (its gradient summed over the ranks)."""
        return collectives.channel_input(x, self.axis)

    def gather(self, x):
        """All channels of a tensor whose last dimension holds this
        rank's channel block."""
        return collectives.gather_channels(x, self.axis)

    def whole(self, name, value):
        """The whole variable ``name`` (stored as ``value``)."""
        return self.gather(value) if name in self._sharded else value

    def fit(self, value, channels):
        """A per-channel tensor for ``channels`` channels: this rank's
        block of a whole one, or the gather of a block."""
        if value.shape[-1] > channels:
            return collectives.channel_block(value, self.axis)
        return self.gather(value)


class TensorParallel(DataParallel):
    """What ``distribute_tp`` installs as an Estimator's ``_parallel``:
    data parallelism over ``data_axis`` with the variables' channel shards
    over ``model_axis``."""

    def __init__(self, mesh, data_axis, model_axis, shardings):
        DataParallel.__init__(self, mesh, data_axis)
        self.shardings = shardings
        self.ctx_kwargs["tensor_parallel"] = ChannelShards(
            mesh.axis(model_axis), shardings)


def _local(sharding, value):
    return sharding.local(value).contiguous().clone()


def distribute_tp(estimator, mesh, data_axis="data", model_axis="model"):
    """Split an Estimator's variables (and their optimizer slots) into
    channel shards over ``model_axis`` (each rank keeps only its own) and
    its batches over ``data_axis``. The global batch size must be
    divisible by the data-axis size. The shards survive
    ``quantize_for_serving`` / ``dequantize_serving``. Returns the
    estimator."""
    _check_device(estimator, mesh)
    shardings = tp_shardings(mesh, estimator.variables, model_axis)
    estimator.variables = {name: _local(shardings[name], value)
                           for name, value in estimator.variables.items()}
    if not estimator.custom_training and estimator.opt_state is not None:
        estimator.opt_state = {
            field: ({name: _local(shardings[name], slot)
                     for name, slot in value.items()}
                    if isinstance(value, dict) else value)
            for field, value in estimator.opt_state.items()}
    estimator._parallel = TensorParallel(mesh, data_axis, model_axis,
                                         shardings)
    return estimator
