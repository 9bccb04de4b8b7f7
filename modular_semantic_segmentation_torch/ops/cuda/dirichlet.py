"""Fused Dirichlet classification: ``csrc/dirichlet.cu`` and its plain twin.

Port of the JAX package's ``ops/pallas/dirichlet_kernel.py``. Per pixel the
label is

    argmax_c  sum_e log(1e-20 + p_e) @ (sigma * alpha_e - 1)  +  bias,
    bias = log(1e-20 + prior) - sum_e log B(sigma * alpha_e),

where the bias is computed on the host in float64 with ``gammaln``, as the
JAX kernel's wrapper does (:func:`dirichlet_tables`).
"""

import ctypes

import numpy as np
import torch
from scipy.special import gammaln

from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

#: shared memory a block may use without opting in
_SMEM_LIMIT = 48 * 1024
#: pixels per block in csrc/dirichlet.cu
_BLOCK_PIXELS = 128

KERNEL = Kernel("dirichlet", "dirichlet_label_launch",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def dirichlet_tables(alphas, prior, sigma, num_classes):
    """Host precompute of the kernel's constants.

    Args:
        alphas: list (per expert) of [K, C] concentrations.
        prior: [C] class prior.
        sigma: temperature of the concentrations.
        num_classes: K, the experts' output width.
    Returns:
        (coeffs [E, K, C] float32 = sigma * alpha - 1,
         bias [C] float32), as numpy arrays. The float64 -> float32 steps
        are those of the JAX kernel's wrapper, so the bias is bit-equal.
    """
    c = np.asarray(alphas[0]).shape[1]
    coeffs = np.zeros((len(alphas), num_classes, c), np.float32)
    bias = np.log(1e-20 + np.asarray(prior, np.float64)).astype(np.float32)
    for e, a in enumerate(alphas):
        a = np.asarray(a, np.float64) * sigma
        coeffs[e] = a - 1.0
        log_beta = gammaln(a).sum(0) - gammaln(a.sum(0))
        bias -= np.asarray(log_beta, np.float32)
    return coeffs, bias


def dirichlet_scores_plain(probs, coeffs, bias):
    """[P, C] float32 fused scores: the plain PyTorch version's arithmetic.

    Args:
        probs: [E, P, K] float32 or bfloat16 probabilities.
        coeffs: [E, K, C] float32; bias: [C] float32.
    """
    total = None
    for e in range(probs.shape[0]):
        term = torch.log(1e-20 + probs[e].float()) @ coeffs[e]
        total = term if total is None else total + term
    return total + bias


def dirichlet_label_plain(probs, coeffs, bias):
    """int32 [P] labels: argmax of :func:`dirichlet_scores_plain` (first
    maximum on ties, as jnp.argmax)."""
    return torch.argmax(dirichlet_scores_plain(probs, coeffs, bias),
                        dim=-1).to(torch.int32)


def dirichlet_label(probs, coeffs, bias):
    """int32 [P] fused labels from stacked probabilities [E, P, K].

    CPU tensors take :func:`dirichlet_label_plain`; CUDA tensors launch
    the kernel, or raise.
    """
    if probs.device.type == "cpu":
        return dirichlet_label_plain(probs, coeffs, bias)
    if probs.device.type != "cuda":
        raise ValueError(f"unsupported device {probs.device}")
    if probs.dim() != 3 or probs.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError("probs must be [E, P, K] float32 or bfloat16, got "
                         f"{tuple(probs.shape)} {probs.dtype}")
    e, p, k = probs.shape
    c = int(bias.shape[0])
    for name, t, shape in (("coeffs", coeffs, (e, k, c)),
                           ("bias", bias, (c,))):
        if (t.device != probs.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{probs.device}")
    smem = 4 * (e * k * c + c + e * _BLOCK_PIXELS * k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{e} experts x {k} classes need {smem} bytes of "
                         "shared memory, more than the kernel takes")
    probs = probs.contiguous()
    coeffs = coeffs.contiguous()
    bias = bias.contiguous()
    out = torch.empty(p, dtype=torch.int32, device=probs.device)
    if p:
        with torch.cuda.device(probs.device):
            KERNEL(probs.data_ptr(), int(probs.dtype == torch.bfloat16),
                   coeffs.data_ptr(), bias.data_ptr(), out.data_ptr(), p, e,
                   k, c, torch.cuda.current_stream(probs.device).cuda_stream)
    return out


def dirichlet_fusion_label(probs, alphas, prior, sigma=1.0):
    """Fused Dirichlet classification, as the JAX kernel's public function.

    Args:
        probs: list (per expert) of [..., K] probabilities.
        alphas: list (per expert) of [K, C] concentrations.
        prior: [C] class prior.
    Returns:
        int32 labels of shape ``probs[0].shape[:-1]``.
    """
    k = probs[0].shape[-1]
    batch_shape = probs[0].shape[:-1]
    stacked = torch.stack([p.reshape(-1, k) for p in probs])
    coeffs, bias = dirichlet_tables(alphas, prior, sigma, k)
    device = stacked.device
    labels = dirichlet_label(stacked, torch.from_numpy(coeffs).to(device),
                             torch.from_numpy(bias).to(device))
    return labels.reshape(batch_shape)
