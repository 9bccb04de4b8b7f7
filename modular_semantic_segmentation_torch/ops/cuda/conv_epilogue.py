"""The served convolutions' epilogue: ``csrc/conv_epilogue.cu`` and its
plain twin.

    y = relu?(bf16(float(x) + bias))

x is a convolution's bf16 output, NHWC with the channels last, bias the
float32 [C] variable: the sum in float32, one rounding to bf16, then the
optional ReLU on the rounded value, as ``ops/layers.conv2d`` computes it
without batch norm (the JAX package's order). :func:`bias_act_` writes it
over x, which ``conv2d`` hands it fresh from the convolution: the plain
twin (:func:`bias_act_plain`, the three PyTorch operations the kernel
replaces) for CPU tensors, the kernel for CUDA tensors, bit for bit the
same values. Each launch is counted in ``KERNEL.launches``.

On a machine whose PyTorch is built for CUDA, importing this module starts
the build of ``csrc/conv_epilogue.cu`` in the background
(``build.build_in_background``), so that it runs under the rest of a
process's set-up; a first launch waits for it.
"""

import ctypes
import math

import torch

from modular_semantic_segmentation_torch.ops.cuda import build
from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

#: threads a block of the kernel (its ``kThreads``)
THREADS = 256
#: resident blocks an SM is given at most: 2048 threads, a full SM
BLOCKS_PER_SM = 8
# vectors a thread moves before the grid strides (the kernel's kUnroll)
_UNROLL = 2

KERNEL = Kernel("conv_epilogue", "conv_epilogue_launch",
                [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
if torch.version.cuda is not None:
    build.build_in_background(KERNEL.source)


def bias_act_plain(x, bias, relu):
    """The plain twin: the chain the kernel replaces, ``x + bias`` in
    float32, cast back to x's dtype, then ``torch.relu`` if ``relu``."""
    out = (x + bias).to(x.dtype)
    return torch.relu(out) if relu else out


def bias_act_(x, bias, relu):
    """x = relu?(bf16(float(x) + bias)), in place, and x returned: x bf16
    [..., C] and contiguous, bias float32 [C] on x's device. Raises on
    another dtype, shape, device or layout. The plain twin for CPU
    tensors, the kernel for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError(f"bias_act_ takes bf16 x and a float32 bias, got "
                         f"{x.dtype} and {bias.dtype}")
    if x.dim() < 1 or tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(f"bias must be [C] of x [..., C], got "
                         f"{tuple(bias.shape)} and {tuple(x.shape)}")
    if bias.device != x.device:
        raise ValueError(f"bias on {bias.device}, x on {x.device}")
    if not x.is_contiguous() or not bias.is_contiguous():
        raise ValueError("bias_act_ takes contiguous x and bias")
    if x.device.type == "cpu":
        return x.copy_(bias_act_plain(x, bias, relu))
    c, numel = int(x.shape[-1]), x.numel()
    vec = vector_width(numel, x.data_ptr())
    if numel:
        sm_count = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        with torch.cuda.device(x.device):
            KERNEL(x.data_ptr(), bias.data_ptr(), numel, c, vec,
                   int(bool(relu)),
                   grid_blocks(numel // vec, c, vec, sm_count),
                   torch.cuda.current_stream(x.device).cuda_stream)
    return x


def vector_width(numel, pointer):
    """bf16 values a thread moves at once: 8 (16 bytes) where the count
    is a multiple of 8 and the pointer 16-byte aligned, else 1."""
    return 8 if numel % 8 == 0 and pointer % 16 == 0 else 1


def grid_blocks(vectors, channels, vec, sm_count):
    """Blocks of THREADS for ``vectors`` vectors of ``vec`` values:
    enough for every vector to be one of a thread's _UNROLL, at most
    BLOCKS_PER_SM an SM, then rounded up so that the grid's stride, in
    values, is a multiple of ``channels``: each of a thread's values then
    has the same channel, and bias, at every step."""
    blocks = min(-(-vectors // (THREADS * _UNROLL)), BLOCKS_PER_SM * sm_count)
    step = channels // math.gcd(channels, THREADS * vec)
    return max(step, -(-blocks // step) * step)
