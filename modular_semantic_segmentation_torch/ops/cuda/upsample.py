"""The frozen channel-diagonal upsample: ``csrc/upsample.cu`` (a phase
gather and its adjoint) and their plain twins.

The function is TF's ``conv2d_transpose`` with SAME padding (out = in *
stride) and a kernel that is diagonal over channels, given as its diagonal
[k, k, C]: the expert CNN's frozen bilinear deconvolutions. The JAX
package computes it with XLA (``ops/fast_upsample.py``, a phase
decomposition into shifted einsums); here output phase p of a stride s
takes ``taps = ceil(k / s)`` taps per dimension from the tap table
(:func:`tap_table`): tap t reads input offset ``d0(p) - t`` with kernel
index ``a0(p) + t * s``, empty where that is k or more.

:func:`diagonal_upsample` is an autograd function whose backward is the
adjoint (:func:`diagonal_upsample_adjoint`); in a program that
``torch.export`` traces it is the registered operator
``msstorch::diagonal_upsample``, so an exported program reaches the kernel
too. Both run the plain twins, which gather from the same table in the
kernels' order, for CPU tensors, and launch the kernels for CUDA tensors,
or raise. No gradient reaches the kernel weights: they are frozen.

While a profiler records, each forward adds one to the counter
``upsample.forward`` and each adjoint one to ``upsample.adjoint``
(``utils/tracing``); on the card each is one launch, counted in
``KERNEL.launches`` or ``ADJOINT.launches``.

On a machine whose PyTorch is built for CUDA, importing this module starts
the builds of ``csrc/upsample.cu`` and ``csrc/upsample_adjoint.cu`` in the
background (``build.build_in_background``), two nvcc at once, so that they
run under the rest of a process's set-up; a first launch waits for its
own library only.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from modular_semantic_segmentation_torch.ops.cuda import build
from modular_semantic_segmentation_torch.ops.cuda.build import Kernel
from modular_semantic_segmentation_torch.utils import tracing

#: the most input columns a thread of the forward walks (its ``run``)
MAX_RUN = 8
# the most images, and output rows, the kernels' grids hold
_MAX_GRID = 65535
# the kernels' element types and their codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6

KERNEL = Kernel("upsample", "upsample_forward_launch",
                _ARGS + [ctypes.c_int] * 3 + [ctypes.c_void_p])
ADJOINT = Kernel("upsample_adjoint", "upsample_adjoint_launch",
                 _ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# (k, s, device) -> the tap table on that device
_TABLES = {}
# device -> its multiprocessor count
_SM_COUNTS = {}

if torch.version.cuda is not None:
    for _source in (KERNEL.source, ADJOINT.source):
        build.build_in_background(_source)


def same_transpose_crop(kernel, stride):
    """Leading crop of a full transposed conv for TF SAME padding with
    out = in * stride: the forward conv's leading pad, (k - s) // 2."""
    return max(kernel - stride, 0) // 2


def tap_table(k, s):
    """int32 [s, 2]: for output phase p, (d0, a0) = divmod(p + lo, s),
    lo = :func:`same_transpose_crop`. Output row q * s + p takes input
    rows q + d0 - t with kernel rows a0 + t * s, t = 0 .. ceil(k/s) - 1
    (those with a kernel row below k); columns alike."""
    shifted = np.arange(s) + same_transpose_crop(k, s)
    return np.stack([shifted // s, shifted % s], axis=1).astype(np.int32)


def phase_taps(k, s):
    """(offsets, kernel indices, valid), each [s, taps], of every tap of
    every phase, from :func:`tap_table`."""
    table = tap_table(k, s).astype(np.int64)
    t = np.arange(-(-k // s))
    offsets = table[:, :1] - t
    indices = table[:, 1:] + s * t
    return offsets, indices, indices < k


def _tap_weights(kernel, indices, valid, ty, tx):
    """(float32 weights [s, 1, s, C], bool mask [s, 1, s, 1]) of tap
    (ty, tx) of every phase (py, px), the weights zero and the mask False
    for an empty tap, shaped for the [N, H, s, W, s, C] gathers of the
    twins."""
    rows, cols = (torch.from_numpy(np.where(valid[:, t], indices[:, t], 0))
                  .to(kernel.device) for t in (ty, tx))
    mask = torch.from_numpy(valid[:, ty, None] & valid[None, :, tx]).to(
        kernel.device)
    weights = kernel[rows][:, cols] * mask[:, :, None]
    return weights[:, None], mask[:, None, :, None]


def _accumulator(dtype):
    """The sums' dtype: float64 for float64 data, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def diagonal_upsample_plain(x, diag_kernel, stride):
    """The plain version: [N, H*s, W*s, C] in x's dtype from x [N, H, W, C]
    and the kernels [k, k, C] (rounded to x's dtype), a phase gather from
    :func:`tap_table` in float32 (float64 for float64 data), tap rows
    outer and tap columns inner as the kernel sums, then one rounding."""
    k, s = int(diag_kernel.shape[0]), int(stride)
    n, h, w, c = x.shape
    offsets, indices, valid = phase_taps(k, s)
    pad = int(np.abs(offsets).max())
    acc = _accumulator(x.dtype)
    padded = F.pad(x.to(acc), (0, 0, pad, pad, pad, pad))
    kernel = diag_kernel.to(x.dtype).to(acc)
    row_q = torch.arange(h, device=x.device)[:, None] + pad
    col_q = torch.arange(w, device=x.device)[:, None] + pad
    out = torch.zeros((n, h, s, w, s, c), dtype=acc, device=x.device)
    for ty in range(offsets.shape[1]):
        rows = row_q + torch.from_numpy(offsets[:, ty]).to(x.device)
        for tx in range(offsets.shape[1]):
            cols = col_q + torch.from_numpy(offsets[:, tx]).to(x.device)
            weights, mask = _tap_weights(kernel, indices, valid, ty, tx)
            # [N, H, s, W, s, C]: input (q + d(py), u + d(px)) for output
            # (q * s + py, u * s + px)
            gathered = padded[:, rows[:, :, None, None],
                              cols[None, None, :, :]]
            out += torch.where(mask, gathered * weights, 0.0)
    return out.reshape(n, h * s, w * s, c).to(x.dtype)


def diagonal_upsample_adjoint_plain(grad, diag_kernel, stride):
    """The plain adjoint: the gradient [N, H, W, C] of
    :func:`diagonal_upsample_plain`'s input from the output's gradient
    [N, H*s, W*s, C], in grad's dtype (float32 sums, float64 for float64
    data; one rounding)."""
    k, s = int(diag_kernel.shape[0]), int(stride)
    n, ho, wo, c = grad.shape
    h, w = ho // s, wo // s
    offsets, indices, valid = phase_taps(k, s)
    pad = int(np.abs(offsets).max())
    acc = _accumulator(grad.dtype)
    # [N, H, s, W, s, C] blocks, padded along the block rows and columns
    blocks = F.pad(grad.to(acc).reshape(n, h, s, w, s, c),
                   (0, 0, 0, 0, pad, pad, 0, 0, pad, pad))
    kernel = diag_kernel.to(grad.dtype).to(acc)
    phase = torch.arange(s, device=grad.device)
    row_i = torch.arange(h, device=grad.device)[:, None] + pad
    col_j = torch.arange(w, device=grad.device)[:, None] + pad
    out = torch.zeros((n, h, w, c), dtype=acc, device=grad.device)
    for ty in range(offsets.shape[1]):
        rows = row_i - torch.from_numpy(offsets[:, ty]).to(grad.device)
        for tx in range(offsets.shape[1]):
            cols = col_j - torch.from_numpy(offsets[:, tx]).to(grad.device)
            weights, mask = _tap_weights(kernel, indices, valid, ty, tx)
            # [N, H, s, W, s, C]: output (q * s + py, u * s + px) with
            # q = i - d(py), u = j - d(px)
            gathered = blocks[:, rows[:, :, None, None],
                              phase[None, :, None, None],
                              cols[None, None, :, :],
                              phase[None, None, None, :]]
            out += torch.where(mask, gathered * weights, 0.0).sum(dim=(2, 4))
    return out.to(grad.dtype)


def diagonal_upsample(x, diag_kernel, stride):
    """[N, H*s, W*s, C] from x [N, H, W, C] (float32, bfloat16 or float64)
    and the kernels [k, k, C], k >= s, rounded to x's dtype. Raises where
    ``diag_kernel`` requires a gradient: none is computed for the kernels.

    Where autograd records the call, an autograd function whose backward
    is the adjoint (:func:`diagonal_upsample_adjoint`); where it records
    nothing (inference mode, no grad, or an input that needs none), the
    forward itself; in a program that ``torch.export`` traces, the
    operator ``msstorch::diagonal_upsample``, which runs the same forward.
    (A ``custom_op``'s first eager call imports ``torch._dynamo``, seconds
    of a process's set-up, and every eager call pays its dispatch.)"""
    if diag_kernel.requires_grad:
        raise ValueError("diagonal_upsample computes no gradient for the "
                         "kernel weights: pass a frozen (detached) "
                         "diag_kernel")
    k, s = int(diag_kernel.shape[0]), int(stride)
    if x.dim() != 4 or tuple(diag_kernel.shape) != (k, k, x.shape[3]):
        raise ValueError(f"x must be [N, H, W, C] and diag_kernel [k, k, C],"
                         f" got {tuple(x.shape)} and "
                         f"{tuple(diag_kernel.shape)}")
    if not 1 <= s <= k:
        raise ValueError(f"the upsample needs 1 <= stride <= kernel, got "
                         f"stride {s}, kernel {k}")
    if x.device.type not in ("cpu", "cuda"):
        # a meta tensor would reach the operator's fake implementation
        raise ValueError(f"unsupported device {x.device}")
    if diag_kernel.dtype != x.dtype:
        diag_kernel = diag_kernel.to(x.dtype)
    if torch.compiler.is_compiling():
        return torch.ops.msstorch.diagonal_upsample(x, diag_kernel, s)
    if x.requires_grad and torch.is_grad_enabled():
        return _Upsample.apply(x, diag_kernel, s)
    return _forward(x, diag_kernel, s)


def diagonal_upsample_adjoint(grad, diag_kernel, stride):
    """The gradient [N, H, W, C] of :func:`diagonal_upsample`'s input from
    its output's gradient ``grad`` [N, H*s, W*s, C], in grad's dtype: the
    plain twin for CPU tensors, the adjoint kernel for CUDA tensors. While
    a profiler records, each call adds one to ``upsample.adjoint``."""
    tracing.count("upsample.adjoint")
    n, ho, wo, c = grad.shape
    if ho % stride or wo % stride:
        raise ValueError(f"the output's gradient {tuple(grad.shape)} is not "
                         f"a multiple of the stride {stride}")
    if grad.device.type == "cpu":
        return diagonal_upsample_adjoint_plain(grad, diag_kernel, stride)
    return _launch(ADJOINT, grad, diag_kernel, stride,
                   (n, ho // stride, wo // stride, c))


def _forward(x, diag_kernel, stride):
    """The forward for either device; counts ``upsample.forward``."""
    tracing.count("upsample.forward")
    if x.device.type == "cpu":
        return diagonal_upsample_plain(x, diag_kernel, stride)
    n, h, w, c = x.shape
    return _launch(KERNEL, x, diag_kernel, stride,
                   (n, h * stride, w * stride, c))


def _setup_context(ctx, inputs, output):
    _, diag_kernel, stride = inputs
    ctx.save_for_backward(diag_kernel)
    ctx.stride = stride


def _backward(ctx, grad):
    (diag_kernel,) = ctx.saved_tensors
    return (diagonal_upsample_adjoint(grad, diag_kernel, ctx.stride), None,
            None)


class _Upsample(torch.autograd.Function):
    """The eager path of :func:`diagonal_upsample` where autograd records
    (a ``forward`` that takes ``ctx``: the form without ``setup_context``
    binds no signature on each call)."""

    @staticmethod
    def forward(ctx, x, diag_kernel, stride):
        _setup_context(ctx, (x, diag_kernel, stride), None)
        return _forward(x, diag_kernel, stride)

    backward = staticmethod(_backward)


@torch.library.custom_op("msstorch::diagonal_upsample", mutates_args=())
def _upsample_op(x: torch.Tensor, diag_kernel: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """The operator that ``torch.export`` records for
    :func:`diagonal_upsample`."""
    return _forward(x, diag_kernel, stride)


@_upsample_op.register_fake
def _(x, diag_kernel, stride):
    n, h, w, c = x.shape
    return x.new_empty((n, h * stride, w * stride, c))


_upsample_op.register_autograd(_backward, setup_context=_setup_context)


def vector_width(c, itemsize, *pointers):
    """Values each thread moves at once: the widest V, V * itemsize at most
    16 bytes, that divides C and to which every pointer is aligned."""
    v = 16 // itemsize
    while v > 1 and (c % v or any(p % (v * itemsize) for p in pointers)):
        v //= 2
    return v


def forward_run(items, sm_count):
    """Input columns each thread of the forward walks, from the count of
    (output pixel, channel vector) items: as many as leave every SM 512
    threads, at most MAX_RUN, so that a thread's weight reads serve
    several outputs where there is work enough. (On an H100 the
    flagship's 4/s2 call, 36,864 items, takes 1, the training batch's
    4/s2 call, 235,520, takes 3 and the 16/s8 calls 8: the fastest or
    within 4% of it in a sweep of 1 to 16.)"""
    return max(1, min(MAX_RUN, items // (512 * sm_count)))


def _table(k, s, device):
    """The tap table on ``device``, made once per (k, s, device)."""
    key = (k, s, device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(tap_table(k, s)).to(device)
    return _TABLES[key]


def _sm_count(device):
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


def _launch(kernel, src, diag_kernel, stride, out_shape):
    """Check the operands and launch the forward (``KERNEL``) or the
    adjoint (``ADJOINT``) on the current stream: ``src`` is x or the
    output's gradient, ``out_shape`` the result's."""
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if src.dtype not in _DTYPES:
        raise ValueError(f"the upsample kernels take float32, bfloat16 or "
                         f"float64, got {src.dtype}")
    k, s = int(diag_kernel.shape[0]), int(stride)
    n, h, w, c = out_shape if kernel is ADJOINT else src.shape
    if diag_kernel.device != device:
        raise ValueError(f"diag_kernel on {diag_kernel.device}, the input "
                         f"on {device}")
    if max(n, h * s) > _MAX_GRID:
        raise ValueError(f"the upsample kernels take at most {_MAX_GRID} "
                         f"images and output rows, got {n} and {h * s}")
    # a copy only for an odd view; the main path's tensors are contiguous
    if not src.is_contiguous():
        src = src.contiguous()
    weights = diag_kernel
    if weights.dtype != src.dtype or not weights.is_contiguous():
        weights = weights.to(src.dtype).contiguous()
    out = torch.empty(out_shape, dtype=src.dtype, device=device)
    vec = vector_width(c, src.element_size(), src.data_ptr(),
                       weights.data_ptr())
    args = [src.data_ptr(), weights.data_ptr(),
            _table(k, s, device).data_ptr(), out.data_ptr(), n, h, w, c, k,
            s]
    if kernel is KERNEL:
        args.append(forward_run(n * h * s * w * s * (c // vec),
                                _sm_count(device)))
    if out.numel():
        with torch.cuda.device(device):
            kernel(*args, _DTYPES[src.dtype], vec,
                   torch.cuda.current_stream(device).cuda_stream)
    return out
