"""Flat, name-addressed variable store for the networks.

The JAX package keeps every variable in one flat ``{tf_name: array}`` dict
and reads it through a scoped context (``ops/variables.Ctx``), so npz weight
files are keyed by TF names like ``rgb/conv1_1/kernel``. The port keeps the
same contract with a ``{tf_name: torch.Tensor}`` dict. Variables are made
up front from a list of specs (``ops/init.py``), never by tracing the
network; a spec also says whether its variable trains, which gives the
``{name: bool}`` map that :func:`split_trainable` partitions by.

In training mode (``Ctx(train=True)``) batch norm normalizes with batch
statistics and records its moving-statistic updates in ``ctx.updates``,
which the train step merges into the new variables, as in the JAX
package: no layer changes a variable in place.

Under the parallel layer (``parallel/``) a context also carries the mesh
axes its computation is split over: ``spatial_axis`` (the frame's height
is sharded: convs exchange row halos, batch norm and the loss sum over the
shards, as the JAX package's ``Ctx(spatial_axis=...)``), ``data_axis``
(the batch is sharded: batch norm and the loss sum over the shards, which
the JAX package's data parallelism gets from XLA) and ``tensor_parallel``
(the variables' channel shards, ``parallel/tensor_parallel.py``).
"""

from contextlib import contextmanager

import torch

from modular_semantic_segmentation_torch.ops.layers import KernelCache

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: ``Ctx(generator=DEFAULT_GENERATOR)``: stochastic layers draw from the
#: device's default generator (``torch.rand`` without a generator), the
#: stream an exported program's draws come from (``serving.py``)
DEFAULT_GENERATOR = "default"


def resolve_device(device):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card, instead of running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


def resolve_dtype(compute_dtype):
    """'float32' | 'bfloat16' -> torch dtype."""
    try:
        return _DTYPES[compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype '{compute_dtype}'") from None


class Ctx:
    """Variable context threaded through the functional layer calls.

    Args:
        variables: flat dict TF name -> tensor.
        compute_dtype: torch dtype inside convolutions; variables stay
            float32.
        kernel_cache: ``ops.layers.KernelCache`` kept across calls; None
            = a fresh one.
        generator: ``torch.Generator`` on the device of the variables,
            the random stream that stochastic layers (MC dropout) draw
            from; :data:`DEFAULT_GENERATOR` for the device's default
            generator; None for a purely deterministic computation.
        act_scales: optional dict full scope name -> float activation
            scale; a conv whose ``<scope>/input_amax`` it holds runs the
            int8 serving path (``models/quantize.py``). None = float
            serving.
        calibrate: when True, convs record the absolute max of their
            input in ``self.amax`` under ``<scope>/input_amax`` (a running
            max over re-entries of the scope) and the input's H*W under
            ``<scope>/input_pixels``.
        calibrate_percentile: below 100, calibration records that
            percentile of |input| instead of its max.
        train: training mode: batch norm uses batch statistics and
            records moving-statistic updates in ``self.updates``; convs
            never take the int8 path.
        spatial_axis: ``parallel.mesh.Axis`` the height is sharded over;
            convs and deconvs exchange row halos with the neighbouring
            shards, and neither takes the int8 path.
        data_axis: ``parallel.mesh.Axis`` the batch is sharded over.
        tensor_parallel: ``parallel.tensor_parallel.ChannelShards`` of the
            variables, when each rank holds channel shards.
    """

    def __init__(self, variables, compute_dtype=torch.float32,
                 kernel_cache=None, generator=None, act_scales=None,
                 calibrate=False, calibrate_percentile=100.0, train=False,
                 spatial_axis=None, data_axis=None, tensor_parallel=None):
        self.variables = variables
        self.train = train
        self.spatial_axis = spatial_axis
        self.data_axis = data_axis
        self.tensor_parallel = tensor_parallel
        self.updates = {}
        self.compute_dtype = compute_dtype
        self.kernel_cache = (KernelCache() if kernel_cache is None
                             else kernel_cache)
        self._generator = generator
        self.act_scales = act_scales
        self.calibrate = calibrate
        self.calibrate_percentile = calibrate_percentile
        self.amax = {}
        self._scope = []

    @contextmanager
    def scope(self, name):
        if name:
            self._scope.append(str(name))
        try:
            yield self
        finally:
            if name:
                self._scope.pop()

    @contextmanager
    def serving_scales(self, act_scales):
        """Run the enclosed layers with ``act_scales`` in place of this
        context's own (the packed expert stems,
        ``models/packed_experts.py``)."""
        saved = self.act_scales
        self.act_scales = act_scales
        try:
            yield self
        finally:
            self.act_scales = saved

    def full_name(self, name):
        return "/".join(self._scope + [name])

    def next_generator(self):
        """The random stream of this computation (counterpart of the JAX
        ``Ctx.next_rng``). One generator advances with every draw, where
        JAX splits its key; the two give different numbers from the same
        seed either way. None for :data:`DEFAULT_GENERATOR`: a draw
        without a generator takes the device's default one."""
        if self._generator is None:
            raise ValueError(
                "This computation needs a random stream (a stochastic "
                "layer) but Ctx was constructed with generator=None.")
        if self._generator is DEFAULT_GENERATOR:
            return None
        return self._generator

    @property
    def sharded_axes(self):
        """The mesh axes the pixels of the batch are sharded over (height
        and batch): batch norm's statistics and the loss sum over them."""
        return tuple(a for a in (self.spatial_axis, self.data_axis)
                     if a is not None)

    def get(self, name):
        """The variable ``<scope>/name``; raises KeyError if missing."""
        full = self.full_name(name)
        try:
            return self.variables[full]
        except KeyError:
            raise KeyError(f"Variable '{full}' not found (available: "
                           f"{len(self.variables)} vars)") from None

    def record_update(self, name, value):
        """Record the new value of the variable ``<scope>/name`` (batch
        norm's moving statistics), detached from autograd."""
        self.updates[self.full_name(name)] = value.detach()


def split_trainable(variables, trainable):
    """Partition a flat variable dict into (trainable, frozen) dicts by
    the ``{name: bool}`` map; a name missing from the map is frozen."""
    train_vars = {k: v for k, v in variables.items()
                  if trainable.get(k, False)}
    frozen_vars = {k: v for k, v in variables.items()
                   if not trainable.get(k, False)}
    return train_vars, frozen_vars
