"""Fused Dirichlet classification: ``csrc/dirichlet.cu`` and its plain twin.

Port of the JAX package's ``ops/pallas/dirichlet_kernel.py``. Per pixel the
label is

    argmax_c  sum_e log(1e-20 + p_e) @ (sigma * alpha_e - 1)  +  bias,
    bias = log(1e-20 + prior) - sum_e log B(sigma * alpha_e),

where the bias is computed on the host in float64 with ``gammaln``, as the
JAX kernel's wrapper does (:func:`dirichlet_tables`). On the card the
kernel reads each expert's probabilities where they lie: the wrapper takes
a list of per-expert [P, K] tensors and passes their pointers, so no
stacked copy is made. It takes the coefficients and the bias by value,
from the host, and, for bfloat16 probabilities, a table of the plain
version's logs by bfloat16 bit pattern (:func:`log_table`).
"""

import ctypes

import numpy as np
import torch
from scipy.special import gammaln

from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

#: shared memory an H100 block may use (after opting in)
_SMEM_LIMIT = 227 * 1024
#: experts, pixels of a slab, ring stages, widest class chunk, log table
#: entries and the limits of by-value coefficients of csrc/dirichlet.cu
#: (kMaxExperts, kSlab, kStages, kMaxChunk, kTableSize, kMaxCoefficients,
#: kMaxClasses)
MAX_EXPERTS = 4
_SLAB = 256
_STAGES = 3
_MAX_CHUNK = 16
LOG_TABLE_SIZE = 16264
_MAX_COEFFICIENTS = 4096
_MAX_CLASSES = 256
#: the kernel's 16-byte copies need each expert's data 16-byte aligned
_ALIGN = 16

KERNEL = Kernel("dirichlet", "dirichlet_label_launch",
                [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p])
_LOG_TABLES = {}


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


def class_chunk(num_classes):
    """Classes per chunk of the kernel: C rounded up to even, at most 16."""
    return min((num_classes + 1) // 2 * 2, _MAX_CHUNK)


def smem_bytes(experts, k, value_bytes):
    """Shared memory of a block of the kernel: the log table (bfloat16
    only), then the ring of slabs. (The coefficients go by value.)"""
    table = 4 * LOG_TABLE_SIZE if value_bytes == 2 else 0
    return table + _STAGES * experts * _SLAB * k * value_bytes


def fits_by_value(experts, k, c):
    """Whether the kernel takes the coefficients of E experts, K inputs
    and C classes as launch parameters: always where K == C is even and at
    most 16 (the compiled-K path), else within its chunk-major limits."""
    cc = class_chunk(c)
    if k == c == cc:
        return True
    chunks = -(-c // cc)
    return (chunks * experts * k * cc <= _MAX_COEFFICIENTS
            and chunks * cc <= _MAX_CLASSES)


def log_table(device):
    """float32 [LOG_TABLE_SIZE]: entry i is ``log(1e-20 + v)`` for the
    bfloat16 v whose bits are i (every v in [0, 1] and a few above),
    computed on ``device`` by the plain version's own operations, so the
    kernel's bfloat16 logs are the plain version's, bit for bit. Made once
    per device."""
    key = str(device)
    if key not in _LOG_TABLES:
        values = torch.arange(LOG_TABLE_SIZE, dtype=torch.int16).view(
            torch.bfloat16).to(device)
        _LOG_TABLES[key] = torch.log(1e-20 + values.float()).contiguous()
    return _LOG_TABLES[key]


def _experts(probs):
    """The per-expert [P, K] tensors of a list, or the views of a stacked
    [E, P, K] tensor."""
    if isinstance(probs, torch.Tensor):
        if probs.dim() != 3:
            raise ValueError(f"stacked probs must be [E, P, K], got "
                             f"{tuple(probs.shape)}")
        return list(probs.unbind(0))
    return list(probs)


def dirichlet_label(probs, coeffs, bias):
    """int32 [P] fused labels.

    Args:
        probs: a list (per expert) of [P, K] probabilities, read in place
            on the card, or one stacked [E, P, K] tensor; float32 or
            bfloat16.
        coeffs: [E, K, C] float32; bias: [C] float32
            (:func:`dirichlet_tables`). The kernel takes them by value as
            launch parameters, so they are read on the host: pass CPU
            tensors (a CUDA tensor is copied back, which waits for the
            card).

    Goes through the registered operator ``msstorch::dirichlet_label``
    (which ``torch.export`` records, so an exported program reaches the
    kernel too): CPU tensors take :func:`dirichlet_label_plain`; CUDA
    tensors launch the kernel, or raise.
    """
    experts = _experts(probs)
    if experts[0].device.type not in ("cpu", "cuda"):
        # a meta tensor would reach the operator's fake implementation
        raise ValueError(f"unsupported device {experts[0].device}")
    return torch.ops.msstorch.dirichlet_label(experts, coeffs, bias)


@torch.library.custom_op("msstorch::dirichlet_label", mutates_args=())
def _dirichlet_label_op(probs: list[torch.Tensor], coeffs: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The operator behind :func:`dirichlet_label`: ``probs`` is the list
    of per-expert [P, K] tensors."""
    device = probs[0].device
    if device.type == "cpu":
        return dirichlet_label_plain(torch.stack(probs), coeffs, bias)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _launch(probs, coeffs, bias)


@_dirichlet_label_op.register_fake
def _(probs, coeffs, bias):
    return probs[0].new_empty((probs[0].shape[0],), dtype=torch.int32)


def _launch(experts, coeffs, bias):
    """Check the inputs and launch the kernel on the current stream."""
    device = experts[0].device
    e = len(experts)
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"the kernel takes 1 to {MAX_EXPERTS} experts, "
                         f"got {e}")
    first = experts[0]
    if first.dim() != 2 or first.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError("probs must be [P, K] float32 or bfloat16 per "
                         f"expert, got {tuple(first.shape)} {first.dtype}")
    for t in experts[1:]:
        if (t.device != device or t.dtype != first.dtype
                or t.shape != first.shape):
            raise ValueError("every expert's probs must match the first's "
                             f"shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    p, k = first.shape
    c = int(bias.shape[0])
    for name, t, shape in (("coeffs", coeffs, (e, k, c)),
                           ("bias", bias, (c,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}")
    smem = smem_bytes(e, k, first.element_size())
    if smem > _SMEM_LIMIT or not fits_by_value(e, k, c):
        raise ValueError(f"{e} experts x {k} inputs x {c} classes exceed "
                         "the kernel's shared memory or its by-value "
                         "coefficients")
    # in place where they are contiguous and aligned (the main path's
    # are); a copy only for an odd view
    experts = [t if t.is_contiguous() and t.data_ptr() % _ALIGN == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in experts]
    coeffs = coeffs.cpu().contiguous()
    bias = bias.cpu().contiguous()
    out = torch.empty(p, dtype=torch.int32, device=device)
    if p:
        pointers = (ctypes.c_void_p * e)(*[t.data_ptr() for t in experts])
        bf16 = first.dtype == torch.bfloat16
        table = log_table(device).data_ptr() if bf16 else None
        with torch.cuda.device(device):
            KERNEL(pointers, int(bf16), coeffs.data_ptr(), bias.data_ptr(),
                   table, out.data_ptr(), p, e, k, c,
                   torch.cuda.current_stream(device).cuda_stream)
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
    coeffs, bias = dirichlet_tables(alphas, prior, sigma, k)
    # host tensors: the plain version on the CPU and the kernel both take
    # them there
    labels = dirichlet_label([p.reshape(-1, k) for p in probs],
                             torch.from_numpy(coeffs),
                             torch.from_numpy(bias))
    return labels.reshape(batch_shape)
