"""int8 convolution of the post-training-quantized serving path.

Counterpart of the int32-accumulating ``lax.conv_general_dilated`` in the
JAX package's int8 branch of ``ops/layers.conv2d``: symmetric int8
operands, int32 sums, no Pallas kernel. PyTorch has no CUDA int8
convolution, so the port computes it as a matrix product:

    * :func:`im2col` gathers the padded int8 input into one [pixels,
      kh*kw*Cin] operand, the taps in the order of the HWIO kernel's rows
      (pad, kh*kw shifted and strided slices, concatenated along the
      channels);
    * :func:`int8_matmul` multiplies it by the int8 kernel into int32. On
      the card that is ``torch._int_mm`` (cuBLASLt's int8 product), whose
      limits (m > 16, k and n multiples of 8) it checks and raises on; on
      the CPU it is :func:`int8_matmul_plain`, the same product in
      float64.

Both are exact: a sum of at most kh*kw*Cin products of two values in
[-127, 127] stays far inside int32. The quantization arithmetic (the
division by the activation scale, round half to even, the per-output-
channel kernel scale) follows the JAX package step for step.

The im2col operand costs memory traffic that an implicit-GEMM kernel
would not: kh*kw bytes per input byte, written once and read once.
"""

from types import SimpleNamespace

import torch
import torch.nn.functional as F

#: calls of ``torch._int_mm`` on the card (``INT_MM.launches``), so a run
#: can show that its serving path went through the int8 product
INT_MM = SimpleNamespace(launches=0)


def quantize(x, scale):
    """int8 ``clip(round(x / scale), -127, 127)``, as the JAX package
    computes it: in float32, a true division, round half to even.

    ``scale`` is a float32 tensor of at least one dimension on ``x``'s
    device: the division then promotes a bfloat16 ``x`` to float32 as it
    loads it (exactly), in one pass, and it divides (PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead)."""
    q = x / scale
    return q.round_().clamp_(-127, 127).to(torch.int8)


def quantize_kernel(kernel):
    """(int8 kernel, float32 per-output-channel scale) of an HWIO float32
    kernel: ``scale = max(max|kernel| over (kh, kw, in), 1e-12) / 127``."""
    amax = torch.amax(torch.abs(kernel), dim=(0, 1, 2))
    scale = torch.clamp_min(amax, 1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=kernel.device)
    return quantize(kernel, scale), scale


_WORDS = ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2),
          (torch.int8, 1))


def im2col(xq, kernel_size, strides, dilation, pads):
    """(patches, output NHW): the [N*Ho*Wo, kh*kw*C] patches of the NHWC
    tensor ``xq``, rows in output-pixel order, columns ordered (tap row,
    tap column, channel) as an HWIO kernel reshaped to [kh*kw*C, out].
    ``pads`` is ((top, bottom), (left, right))."""
    (kh, kw), (sh, sw), (dh, dw) = kernel_size, strides, dilation
    (pt, pb), (pl, pr) = pads
    n, h, w, c = xq.shape
    ho = (h + pt + pb - dh * (kh - 1) - 1) // sh + 1
    wo = (w + pl + pr - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw, sh, sw) == (1, 1, 1, 1) and pt == pb == pl == pr == 0:
        return xq.reshape(n * h * w, c), (n, h, w)
    # copy a pixel's channels as whole 8-, 4- or 2-byte words where C
    # allows: the same bytes in a fraction of the elements, which is what
    # PyTorch's pad and concatenation pay for
    word = next(dtype for dtype, size in _WORDS if c % size == 0)
    xp = F.pad(xq.contiguous().view(word), (0, 0, pl, pr, pt, pb))
    taps = [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    patches = torch.cat(taps, dim=-1).view(torch.int8)
    return patches.reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


def int8_matmul_plain(a, b_t):
    """int32 ``a @ b_t.T`` of int8 [M, K] and [N, K], as a float64 product:
    exact, since every product and partial sum is an integer of magnitude
    at most K * 127**2, far below 2**53; and it runs on the card too,
    where PyTorch has no integer matrix product."""
    return (a.double() @ b_t.double().t()).to(torch.int32)


def int8_matmul(a, b_t):
    """int32 ``a @ b_t.T`` of int8 [M, K] and int8 [N, K].

    On the card, ``torch._int_mm``; raises ValueError on a shape it does
    not take (m <= 16, or k or n not a multiple of 8), so no caller drops
    to another path unseen. On the CPU, :func:`int8_matmul_plain`."""
    if a.device.type != "cuda":
        return int8_matmul_plain(a, b_t)
    m, k = a.shape
    n = b_t.shape[0]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"torch._int_mm needs m > 16 and k, n multiples of 8; the int8 "
            f"conv gives m={m}, k={k}, n={n}")
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    INT_MM.launches += 1
    return out


def int8_conv2d(xq, kq_t, kernel_size, strides, dilation, pads):
    """int32 NHWC convolution of the int8 NHWC ``xq`` by the int8 kernel
    ``kq_t`` ([out, kh*kw*in], the HWIO kernel reshaped and transposed).
    ``pads`` as :func:`im2col` takes them."""
    patches, nhw = im2col(xq, kernel_size, strides, dilation, pads)
    return int8_matmul(patches, kq_t).reshape(*nhw, kq_t.shape[0])
