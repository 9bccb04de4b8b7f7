"""The collectives of the parallel layer, written out, with their
gradients.

In the JAX package XLA inserts these from shardings (data and tensor
parallelism) or ``shard_map`` bodies call them (``psum``, ``ppermute``,
``all_gather``; spatial partitioning). Here each is a
``torch.distributed`` call on an :class:`~.mesh.Axis`'s process group,
and the differentiable ones are ``torch.autograd.Function``s whose
backward is the transposed collective. Two conventions, one per kind of
axis:

* over an axis the DATA is split along (batch or height), every rank
  differentiates its own copy of a replicated value, as JAX's
  ``shard_map`` does: the transpose of a sum over ranks is a sum over
  ranks (:func:`all_reduce`), of a gather a sum then this rank's block
  (:func:`all_gather`), of a halo exchange the exchange back
  (:func:`halo_exchange_rows`). Each rank's parameter gradient then
  carries the axis size as a factor, and the step takes the mean over
  the axis (the JAX package's ``pmean``);
* over an axis the CHANNELS are split along (tensor parallelism), what
  follows a gather is computed alike on every rank, so the transpose of
  a gather is this rank's block (:func:`gather_channels`), and of taking
  this rank's block of a replicated tensor, a gather of the blocks
  (:func:`channel_block`); the whole input of an op that computes only
  this rank's output channels takes the sum of every rank's gradient
  (:func:`channel_input`, Megatron's identity / all-reduce pair).

Point-to-point sends go through host memory under gloo on CUDA tensors
(``Mesh.stages``); every other collective runs where its tensor lies.
"""

import torch
import torch.distributed as dist


# ------------------------------------------------------------- no gradient

def all_reduce_(tensor, axis):
    """Sum ``tensor`` over ``axis`` in place; returns it."""
    dist.all_reduce(tensor, group=axis.group)
    return tensor


def all_gather_(tensor, axis, dim):
    """The blocks of every rank along ``axis``, concatenated in axis order
    along ``dim``."""
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(axis.size)]
    dist.all_gather(parts, tensor, group=axis.group)
    return torch.cat(parts, dim=dim)


def _block(tensor, axis, dim):
    size = tensor.shape[dim] // axis.size
    return tensor.narrow(dim, axis.index * size, size)


def mean_(tensors, axis):
    """Replace each tensor of the list by its mean over ``axis``, in one
    flat all-reduce (hierarchical on a multislice axis, see
    :func:`hierarchical_all_reduce_`)."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh = axis.mesh
    if mesh.dcn_axis in axis.names and len(axis.names) > 1:
        ici = tuple(n for n in axis.names if n != mesh.dcn_axis)
        hierarchical_all_reduce_(flat, mesh.axis(ici),
                                 mesh.axis(mesh.dcn_axis))
    else:
        all_reduce_(flat, axis)
    flat /= axis.size
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def hierarchical_all_reduce_(flat, ici, dcn):
    """Sum a flat tensor over the product of ``ici`` (within a slice) and
    ``dcn`` (across slices), in place: a reduce-scatter within the slice,
    an all-reduce of each shard across slices, an all-gather within the
    slice. Equals the flat all-reduce up to the order of the sums."""
    n = flat.numel()
    padded = torch.nn.functional.pad(flat, (0, (-n) % ici.size))
    shard = torch.empty(padded.numel() // ici.size, dtype=flat.dtype,
                        device=flat.device)
    dist.reduce_scatter_tensor(shard, padded, group=ici.group)
    all_reduce_(shard, dcn)
    gathered = torch.empty_like(padded)
    dist.all_gather_into_tensor(gathered, shard, group=ici.group)
    flat.copy_(gathered[:n])
    return flat


def exchange_rows(axis, send_down, send_up):
    """Send ``send_down`` to the next rank along ``axis`` and ``send_up``
    to the previous one; returns (received from the previous rank,
    received from the next), zeros at the ends of the axis. Point to
    point, staged through host memory where the backend needs it."""
    device = send_down.device
    send_down, send_up = send_down.contiguous(), send_up.contiguous()
    staged = axis.mesh.stages("send/recv", send_down)
    if staged:
        send_down, send_up = send_down.cpu(), send_up.cpu()
    from_above = torch.zeros(send_down.shape, dtype=send_down.dtype,
                             device=send_down.device)
    from_below = torch.zeros(send_up.shape, dtype=send_up.dtype,
                             device=send_up.device)
    ops = []
    if axis.index + 1 < axis.size:
        below = axis.ranks[axis.index + 1]
        ops += [dist.P2POp(dist.isend, send_down, below, axis.group),
                dist.P2POp(dist.irecv, from_below, below, axis.group)]
    if axis.index > 0:
        above = axis.ranks[axis.index - 1]
        ops += [dist.P2POp(dist.isend, send_up, above, axis.group),
                dist.P2POp(dist.irecv, from_above, above, axis.group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        from_above, from_below = from_above.to(device), from_below.to(device)
    return from_above, from_below


# ------------------------------------------------- over a sharded data axis

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis):
        ctx.axis = axis
        return all_reduce_(tensor.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.axis), None


def all_reduce(tensor, axes):
    """Sum over each axis of ``axes`` (an Axis or a tuple of them); the
    JAX package's ``psum``, whose transpose is a ``psum``."""
    for axis in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        tensor = _AllReduce.apply(tensor, axis)
    return tensor


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_(tensor, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_(grad.contiguous().clone(), ctx.axis)
        return _block(total, ctx.axis, ctx.dim).contiguous(), None, None


def all_gather(tensor, axis, dim):
    """The JAX package's tiled ``all_gather`` along ``dim``; its transpose
    sums the gradient over the axis and keeps this rank's block (a
    reduce-scatter)."""
    return _AllGather.apply(tensor, axis, dim)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, rows):
        ctx.axis, ctx.rows, ctx.shape = axis, rows, x.shape
        return exchange_rows(axis, x[:, -rows:], x[:, :rows])

    @staticmethod
    def backward(ctx, grad_above, grad_below):
        # the rows received from above came from the previous rank's
        # bottom: their gradient goes back up, and the gradient of this
        # rank's top rows comes down from it (and alike below)
        rows = ctx.rows
        to_top, to_bottom = exchange_rows(ctx.axis, grad_below.contiguous(),
                                          grad_above.contiguous())
        grad = grad_above.new_zeros(ctx.shape)
        grad[:, :rows] += to_top
        grad[:, -rows:] += to_bottom
        return grad, None, None


def halo_exchange_rows(x, axis, rows=1):
    """(top halo, bottom halo): the ``rows`` boundary rows of the
    neighbouring blocks of an NHWC tensor whose height is split over
    ``axis``, zeros at the frame's edges (SAME zero padding); the JAX
    package's ring ``ppermute`` with its wrapped edges zeroed."""
    return _Halo.apply(x, axis, rows)


# ---------------------------------------------- over a sharded channel axis

class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_(tensor, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.axis, ctx.dim).contiguous(), None, None


def gather_channels(tensor, axis, dim=-1):
    """Every rank's channel block along ``dim`` concatenated; the
    gradient is this rank's block of the (replicated) gradient."""
    return _GatherChannels.apply(tensor, axis, dim % tensor.dim())


class _ChannelBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(tensor, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_(grad, ctx.axis, ctx.dim), None, None


def channel_block(tensor, axis, dim=-1):
    """This rank's channel block of a tensor every rank holds whole; the
    gradient of the whole is the gather of every rank's block's."""
    return _ChannelBlock.apply(tensor, axis, dim % tensor.dim())


class _ChannelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis):
        ctx.axis = axis
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.axis), None


def channel_input(tensor, axis):
    """``tensor`` (whole on every rank) as the input of an op that
    computes this rank's channel block only: the identity, whose gradient
    is the sum of every rank's, each holding its own channels' part."""
    return _ChannelInput.apply(tensor, axis)
