"""Device meshes over ``torch.distributed`` ranks (counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package is single-controller: one process drives every device of a
``jax.sharding.Mesh``, and XLA inserts the collectives that the shardings
imply. PyTorch's idiom is SPMD: one process per rank
(``parallel/launch.py`` starts them), each running the same program on its
own shard, with the collectives written out (``parallel/collectives.py``).
A :class:`Mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the JAX package's axis names, the device this rank
computes on, and the process group of each axis.

Shardings (:func:`replicated`, :func:`batch_sharded`,
:func:`spatial_sharded`) say which tensor dimension lies split over which
mesh axis, as a ``PartitionSpec`` does, and cut a rank's block out of a
global tensor or gather the blocks back.

Backends: NCCL needs one card per rank; gloo runs on the CPU and takes
CUDA tensors for every collective the port uses except point-to-point
sends, which the port stages through host memory
(:meth:`Mesh.stages`), recording each staged collective in
``Mesh.staged``.
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

#: collectives that gloo does not run on CUDA tensors: point-to-point
#: sends between the ranks (the halo exchange's); the port copies their
#: tensors to host memory and back
GLOO_HOST_STAGED = frozenset({"send/recv"})


def _world():
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: start the ranks with "
            "parallel.launch.launch (or call init_process_group)")
    return dist.get_world_size()


def _rank_device(device):
    """This rank's device: 'cpu', or the card the launcher set current
    for this rank when ``device`` is 'cuda' without an index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Axis:
    """One mesh axis, or a product of axes, as this rank sees it: its
    process group, its size and this rank's index along it.

    Attributes:
        mesh: the :class:`Mesh`.
        names: tuple of axis names (one, or several for a product axis).
        group: the ``torch.distributed`` process group of this rank's
            line along the axis.
        ranks: the global ranks of the group, in axis order.
        size, index: the group's size and this rank's position in it.
    """

    def __init__(self, mesh, names, group):
        self.mesh = mesh
        self.names = names
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    def __repr__(self):
        return f"Axis({'x'.join(self.names)}, {self.index}/{self.size})"


class Mesh:
    """A named mesh of ranks (see the module docstring).

    Attributes:
        device_mesh: the ``DeviceMesh``.
        shape: {axis name: size}, as ``jax.sharding.Mesh.shape``.
        axis_names: the names, outermost first.
        device: the ``torch.device`` this rank computes on.
        backend: the process groups' backend ('nccl' or 'gloo').
        dcn_axis: the slice axis of a multislice mesh
            (:func:`make_multislice_mesh`), else None.
        staged: names of the collectives that ran staged through host
            memory.
    """

    def __init__(self, device_mesh, device, dcn_axis=None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device = device
        self.backend = dist.get_backend()
        self.dcn_axis = dcn_axis
        self.staged = set()
        self._axes = {}

    def axis(self, names):
        """The :class:`Axis` of one axis name, or of a tuple of names (the
        product of those axes). Every rank must ask for a product axis
        first at the same point of the program: its group is made then,
        collectively."""
        names = (names,) if isinstance(names, str) else tuple(names)
        for name in names:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis '{name}' (axes "
                                 f"{self.axis_names})")
        if names not in self._axes:
            if len(names) == 1:
                group = self.device_mesh.get_group(names[0])
            elif set(names) == set(self.axis_names):
                group = dist.group.WORLD
            else:
                group = self._product_group(names)
            self._axes[names] = Axis(self, names, group)
        return self._axes[names]

    def _product_group(self, names):
        """Process group of this rank's slab along the product of the
        named axes (made with every other slab's, collectively)."""
        grid = self.device_mesh.mesh
        keep = [self.axis_names.index(n) for n in names]
        rest = [i for i in range(grid.dim()) if i not in keep]
        slabs = grid.permute(*rest, *keep).reshape(
            -1, math.prod(grid.shape[i] for i in keep))
        group, _ = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in slabs])
        return group

    def stages(self, collective, tensor):
        """Whether ``collective`` runs on a host copy of ``tensor``: for
        gloo on CUDA tensors where gloo lacks it (:data:`GLOO_HOST_STAGED`).
        Records the collective in ``staged`` when it does."""
        if (self.backend == "gloo" and tensor.is_cuda
                and collective in GLOO_HOST_STAGED):
            self.staged.add(collective)
            return True
        return False


def make_mesh(axis_sizes=None, device="cuda"):
    """Create a :class:`Mesh` over the ranks of the initialized process
    group; every rank calls it.

    Args:
        axis_sizes: dict {axis name: size} (e.g. {'data': 8}); sizes must
            multiply to the rank count. None -> all ranks on one 'data'
            axis.
        device: 'cuda' (this rank's current card, as the launcher sets
            it) or 'cpu'.
    """
    world = _world()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    total = math.prod(axis_sizes.values())
    if total != world:
        raise ValueError(
            f"mesh axes {axis_sizes} need {total} devices, have {world}")
    device = _rank_device(device)
    device_mesh = init_device_mesh(device.type, tuple(axis_sizes.values()),
                                   mesh_dim_names=tuple(axis_sizes))
    return Mesh(device_mesh, device)


def make_multislice_mesh(num_slices, ici_axes=None, dcn_axis="slice",
                         device="cuda"):
    """A two-level mesh, as the JAX package's DCN x ICI mesh of a
    multi-slice pod: the leading ``dcn_axis`` spans slices, the
    ``ici_axes`` the ranks within one slice, laid out slice-major.

    For data-parallel training, pass ``(dcn_axis, *ici_axes)`` as
    ``distribute``'s ``data_axis``: the gradient is then reduced
    hierarchically (reduce-scatter within each slice, all-reduce of the
    shards across slices, all-gather within the slice), which keeps the
    cross-slice payload at 1/ici_size of the gradient bytes.

    Args:
        num_slices: number of slices.
        ici_axes: dict {axis: size} within one slice; default puts all of
            a slice's ranks on a 'data' axis.
        device: as :func:`make_mesh`.
    """
    world = _world()
    if world % num_slices:
        raise ValueError(
            f"{world} devices not divisible into {num_slices} slices")
    per_slice = world // num_slices
    if ici_axes is None:
        ici_axes = {"data": per_slice}
    if math.prod(ici_axes.values()) != per_slice:
        raise ValueError(
            f"ici axes {ici_axes} need {math.prod(ici_axes.values())} "
            f"devices per slice, have {per_slice}")
    device = _rank_device(device)
    names = (dcn_axis,) + tuple(ici_axes)
    shape = (num_slices,) + tuple(ici_axes.values())
    device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
    return Mesh(device_mesh, device, dcn_axis=dcn_axis)


class Sharding:
    """Which tensor dimension is split over which mesh axis, as a
    ``NamedSharding(mesh, PartitionSpec(...))``: ``spec[d]`` is the axis
    name (or tuple of names) dimension ``d`` is split over, or None.
    Dimensions past the spec are not split."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Sharding({self.spec})"

    @property
    def is_fully_replicated(self):
        return all(s is None for s in self.spec)

    def local(self, tensor):
        """This rank's block of a global tensor (a view)."""
        for dim, names in enumerate(self.spec):
            if names is None or dim >= tensor.dim():
                continue
            axis = self.mesh.axis(names)
            size = tensor.shape[dim]
            if size % axis.size:
                raise ValueError(
                    f"dimension {dim} of size {size} does not split over "
                    f"{axis.size} ranks of axis {names}")
            block = size // axis.size
            tensor = tensor.narrow(dim, axis.index * block, block)
        return tensor

    def gather(self, tensor):
        """The global tensor from every rank's block (no gradient)."""
        from modular_semantic_segmentation_torch.parallel import collectives
        for dim in reversed(range(len(self.spec))):
            names = self.spec[dim]
            if names is None or dim >= tensor.dim():
                continue
            tensor = collectives.all_gather_(tensor, self.mesh.axis(names),
                                             dim)
        return tensor


def replicated(mesh):
    """Every rank holds the whole tensor."""
    return Sharding(mesh, ())


def batch_sharded(mesh, axis="data"):
    """The leading (batch) dimension split over ``axis``."""
    return Sharding(mesh, (axis,))


def spatial_sharded(mesh, axis="data"):
    """The height dimension of NHWC tensors split over ``axis``."""
    return Sharding(mesh, (None, axis))
