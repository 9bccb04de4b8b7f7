"""3x3 stem conv + bias + ReLU: ``csrc/stem_conv.cu`` and its plain twin.

Port of ``scripts/pallas_stem_conv_probe.py`` (``pallas_conv_nhwc`` and its
kernel ``conv3x3_rowlanes``): a 3x3 SAME convolution, stride 1, of a
bfloat16 NHWC input with an HWIO kernel, float32 accumulation, a float32
bias, ReLU, bfloat16 NHWC output. Like the probe, it is measured at
conv1_2 of the flagship expert (768x384, 64 -> 64) and is not wired into
the experts, whose convs stay ``ops/layers.conv2d``.

The kernel's layouts are made and chosen here, where the CPU tests reach
them: :func:`pack_weights` lays the weights out as the kernel's wgmma
reads them from shared memory, and :func:`tile_config` picks the input
channels of each stage of its patch ring so that a block fits the card's
shared memory.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from modular_semantic_segmentation_torch.ops.cuda.build import Kernel

KERNEL = Kernel("stem_conv", "stem_conv_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: csrc/stem_conv.cu's constants: output channels of a block (the wgmma's
#: M), output rows and columns of a tile, warpgroups and ring stages
COUT_CHUNK = 64
TILE_ROWS = 4
TILE_W = 64
WARPGROUPS = 2
STAGES = 2
#: shared memory an H100 block may use (227 KB)
SMEM_LIMIT = 232448


def pack_weights(kernel):
    """[3, 3, Cin, Cout] HWIO weights in the kernel's shared-memory layout.

    The [9*Cin, Cout] matrix (row k = (dy*3 + dx)*Cin + ci), its Cout
    padded with zeros to a multiple of 64, becomes [Cout/64][9*Cin/16][8]
    [2][8][8]: per chunk of 64 output channels and step of 16 K values, the
    wgmma A operand (64 channels x 16 K) as 8 x 2 core matrices, each 8
    channels x 8 consecutive K values (16 bytes a row). Element
    ``[j, s, g, h, r, c]`` is ``wmat[16*s + 8*h + c, 64*j + 8*g + r]``.
    Returns a contiguous tensor of the kernel's dtype and device.
    """
    cin, cout = kernel.shape[2], kernel.shape[3]
    chunks = -(-cout // COUT_CHUNK)
    wmat = kernel.reshape(9 * cin, cout)
    padded = wmat.new_zeros((9 * cin, chunks * COUT_CHUNK))
    padded[:, :cout] = wmat
    # axes (s, h, c, j, g, r) -> (j, s, g, h, r, c)
    return padded.reshape(9 * cin // 16, 2, 8, chunks, 8, 8).permute(
        3, 0, 4, 1, 5, 2).contiguous()


def unpack_weights(packed, cin, cout):
    """The [9*Cin, Cout] matrix back from :func:`pack_weights`."""
    chunks = packed.shape[0]
    return packed.permute(1, 3, 5, 0, 2, 4).reshape(
        9 * cin, chunks * COUT_CHUNK)[:, :cout]


def smem_bytes(cin, cg):
    """Shared memory of a block: the packed weights of one chunk of 64
    output channels, the staged output rows (64 pixels x 72 bf16 values a
    warpgroup) and a ring of patches of ``cg`` channels, each channel group
    a plane of (TILE_ROWS + 2) x (TILE_W + 2) pixels of 16 bytes plus 16
    bytes of padding (the same sum as ``smem_bytes`` in the source)."""
    plane = ((TILE_ROWS + 2) * (TILE_W + 2) + 1) * 16
    return (9 * cin * COUT_CHUNK * 2
            + WARPGROUPS * TILE_W * (COUT_CHUNK + 8) * 2
            + STAGES * (cg // 8) * plane)


def tile_config(cin):
    """The kernel's choice for ``cin`` input channels: the most channels a
    ring stage can hold (a multiple of 16 that divides Cin) such that the
    block fits 227 KB. Returns ``{"cg": channels per stage, "smem":
    bytes}``; raises if Cin is not a multiple of 16."""
    if cin <= 0 or cin % 16:
        raise ValueError(f"the kernel takes Cin a multiple of 16, got {cin}")
    for cg in range(cin, 0, -16):
        if cin % cg == 0 and smem_bytes(cin, cg) <= SMEM_LIMIT:
            return {"cg": cg, "smem": smem_bytes(cin, cg)}
    raise ValueError(f"no ring stage fits shared memory at Cin {cin}")


def conv3x3_f32(x, kernel):
    """The plain version's arithmetic: the 9 shifted slices of the
    zero-padded bfloat16 input through one float32 [P, 9*Cin] @
    [9*Cin, Cout] product.

    Args:
        x: [N, H, W, Cin]; kernel: [3, 3, Cin, Cout]; both cast to
            bfloat16 first.
    Returns:
        [N, H, W, Cout] float32, before bias and ReLU.
    """
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    xp = F.pad(x.to(torch.bfloat16), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + w, :]
                         for dy in range(3) for dx in range(3)], dim=-1)
    wmat = kernel.to(torch.bfloat16).reshape(9 * cin, cout).float()
    return (patches.reshape(-1, 9 * cin).float() @ wmat).reshape(
        n, h, w, cout)


def stem_conv_nhwc_plain(x, kernel, bias):
    """The plain PyTorch version: :func:`conv3x3_f32`, plus bias, ReLU,
    cast to bfloat16.

    Args:
        x: [N, H, W, Cin]; kernel: [3, 3, Cin, Cout]; bias: [Cout].
    Returns:
        [N, H, W, Cout] bfloat16.
    """
    out = conv3x3_f32(x, kernel) + bias.float()
    return torch.relu(out).to(torch.bfloat16)


def stem_conv_nhwc(x, kernel, bias):
    """3x3 SAME conv + bias + ReLU, NHWC bfloat16 in and out.

    Counterpart of the probe's ``pallas_conv_nhwc``. CPU tensors take
    :func:`stem_conv_nhwc_plain`; CUDA tensors launch the kernel, or raise.

    Args:
        x: [N, H, W, Cin], cast to bfloat16; Cin a multiple of 16 on the
            card, at most 128 (the kernel's launcher returns an error
            above).
        kernel: [3, 3, Cin, Cout] HWIO, cast to bfloat16; Cout a multiple
            of 8 on the card.
        bias: [Cout], cast to float32.
    """
    if x.device.type == "cpu":
        return stem_conv_nhwc_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"kernel must be [3, 3, {cin}, Cout], got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [{cout}], got {tuple(bias.shape)}")
    if cin % 16 or cout % 8:
        raise ValueError(f"the kernel takes Cin a multiple of 16 and Cout a "
                         f"multiple of 8, got Cin {cin}, Cout {cout}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    config = tile_config(cin)
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte copies
        x = x.clone()
    packed = pack_weights(kernel.to(torch.bfloat16))
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            KERNEL(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), n, h, w, cin, cout, config["cg"],
                   torch.cuda.current_stream(x.device).cuda_stream)
    return out


def library_conv_nhwc(x, weight_oihw, bias):
    """The cuDNN yardstick of the same function: ``F.conv2d`` with bias on
    the channels-last view of the NHWC bfloat16 input, then ReLU; the
    result is NHWC in memory. ``weight_oihw`` is the kernel already in
    PyTorch's [Cout, Cin, 3, 3] channels-last layout and ``bias`` bfloat16,
    so the call times the convolution alone. Timed beside the kernel by
    :func:`probe`; the port never calls it."""
    return torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), weight_oihw, bias,
                                padding=1))


def probe_inputs(height, width, cin, cout, seed=0, batch=1):
    """Seeded host inputs as the probe's ``main()`` makes them: a
    standard-normal input, kernel and bias scaled by 0.1 (float32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, height, width, cin).astype(np.float32)
    kernel = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1
    bias = rng.randn(cout).astype(np.float32) * 0.1
    return x, kernel, bias


def bound_bytes_and_flops(batch, height, width, cin, cout):
    """Bytes the function must move (bf16 input and output, bf16 weights,
    float32 bias, each once) and its multiply-adds counted as 2 operations
    each."""
    pixels = batch * height * width
    n_bytes = 2 * pixels * (cin + cout) + 2 * 9 * cin * cout + 4 * cout
    return n_bytes, 2.0 * 9 * cin * cout * pixels


def probe(height=768, width=384, cin=64, cout=64, seed=0, device="cuda",
          batch=1, timings=True):
    """The port's counterpart of the probe's ``main()``.

    Makes seeded inputs (:func:`probe_inputs`), runs the kernel and its
    plain version on them and checks ``max|kernel - plain| <= 1e-2 *
    max|plain|``; raises if not. On the card, with ``timings``, it also
    times, each call after an L2 flush: the wrapper's call with CUDA
    events, the kernel alone with torch.profiler, the plain version and
    the cuDNN yardstick (:func:`library_conv_nhwc`). The yardstick and the
    kernel are timed in turns (yardstick, call, kernel alone, kernel
    alone, call, yardstick), each result the mean of its two turns.

    Returns:
        dict with 'max_abs_err', 'scale' (max|plain|) and, when timed,
        'ms', 'kernel_ms', 'plain_ms', 'library_ms' (milliseconds; None
        where the profiler recorded no device time), plus 'n_bytes' and
        'n_flops'.
    """
    x, kernel, bias = probe_inputs(height, width, cin, cout, seed, batch)
    x = torch.from_numpy(x).to(device, torch.bfloat16)
    kernel = torch.from_numpy(kernel).to(device, torch.bfloat16)
    bias = torch.from_numpy(bias).to(device)
    got = stem_conv_nhwc(x, kernel, bias)
    want = stem_conv_nhwc_plain(x, kernel, bias)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= 1e-2 * scale:
        raise RuntimeError(
            f"stem conv kernel differs from its plain version by {err} at "
            f"[{batch}, {height}, {width}, {cin}] -> {cout} (max|plain| "
            f"{scale})")
    n_bytes, n_flops = bound_bytes_and_flops(batch, height, width, cin, cout)
    result = {"max_abs_err": err, "scale": scale, "n_bytes": n_bytes,
              "n_flops": n_flops}
    if timings and x.device.type == "cuda":
        from modular_semantic_segmentation_torch.utils.profiling import (
            cold_ms, kernel_ms)
        weight_oihw = kernel.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bias_bf16 = bias.to(torch.bfloat16)
        call = lambda: stem_conv_nhwc(x, kernel, bias)  # noqa: E731
        library = lambda: library_conv_nhwc(  # noqa: E731
            x, weight_oihw, bias_bf16)
        turns = [cold_ms(library), cold_ms(call),
                 kernel_ms(call, "stem_conv_kernel"),
                 kernel_ms(call, "stem_conv_kernel"), cold_ms(call),
                 cold_ms(library)]
        alone = [t for t in turns[2:4] if t is not None]
        result["library_ms"] = (turns[0] + turns[5]) / 2
        result["ms"] = (turns[1] + turns[4]) / 2
        result["kernel_ms"] = sum(alone) / len(alone) if alone else None
        result["plain_ms"] = cold_ms(
            lambda: stem_conv_nhwc_plain(x, kernel, bias))
    return result
